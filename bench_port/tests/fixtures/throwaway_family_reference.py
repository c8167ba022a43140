"""A model family added from files alone, for the tests: Qwen2-Audio's
reference side under another name."""

from reference.families.qwen2_audio import *  # noqa: F401,F403
