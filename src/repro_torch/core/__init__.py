"""Message plane: quantization codecs, serialization, wire pipeline, streaming."""
