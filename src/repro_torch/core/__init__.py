"""Masks, cache, selection rules and block-decode helpers of the port."""
