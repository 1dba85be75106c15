"""Task entry points (port of cinema_tpu/tasks)."""
