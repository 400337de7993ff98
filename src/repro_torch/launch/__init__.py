"""Entry points: ``serve`` (batched prefill + decode)."""
