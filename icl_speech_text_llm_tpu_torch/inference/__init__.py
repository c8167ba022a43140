"""Static generation engine and the inference runner."""
