"""Model substrate: the dense ``DecoderLM`` family."""
