"""Entry points: ``train`` (the centralized trainer, or one FL site's
local trainer), ``serve`` (batched prefill + decode), ``fl_train`` (the
mesh-view trainer) and ``federation`` (the live plane over TCP)."""
