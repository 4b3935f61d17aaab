"""LM layers: ``spectral`` (the gated FFT long-convolution mixer)."""
