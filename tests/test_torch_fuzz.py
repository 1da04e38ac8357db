"""The JAX package's wire fuzzer tests (``tests/test_fuzz.py``) on the
port's ``testing/fuzz.py`` and wire codec, its imports renamed
(``torch_mirror``), and the same seeded fuzz runs held against the JAX
package's: equal corpus and stream digests and equal reports.
"""

import dataclasses

import pytest

import consensus_tpu.testing.fuzz as jfuzz
from torch_mirror import mirror

mirror("test_fuzz", globals())


@pytest.mark.parametrize("seed", [0, 0xBEEF, 2026])
def test_fuzz_run_equals_the_jax_packages(seed):
    ours = run_fuzz(seed=seed, frames_per_case=300)  # noqa: F821
    theirs = jfuzz.run_fuzz(seed=seed, frames_per_case=300)
    assert ours.ok()
    assert ours.corpus_digest == theirs.corpus_digest
    assert ours.stream_digest == theirs.stream_digest
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_seed_corpus_equals_the_jax_packages():
    assert seed_corpus() == jfuzz.seed_corpus()  # noqa: F821
