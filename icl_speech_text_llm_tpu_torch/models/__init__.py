"""Models: Whisper, BEATs, Q-Former, LLaMA/Vicuna and the SALMONN composition."""
