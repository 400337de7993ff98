"""Entry points: ``serve`` (batched prefill + decode), ``fl_train`` (the
mesh-view trainer) and ``federation`` (the live plane over TCP)."""
