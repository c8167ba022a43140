"""A model family added from files alone, for the tests: Qwen2-Audio's
harness side under another name."""

from benchlib.families.qwen2_audio import *  # noqa: F401,F403
