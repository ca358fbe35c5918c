"""Training-side modules; only the serve-side fault hooks are ported."""
