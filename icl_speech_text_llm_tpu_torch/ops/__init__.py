"""Ops: attention, the Hopper kernel wrappers and the mel frontend."""
