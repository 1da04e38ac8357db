"""Test helpers of the port."""
