"""Multi-process runs of the port (port of cinema_tpu/parallel): the process group and the manifest
shards (``multihost``), and the ('data', 'model') mesh with data parallelism, FSDP and head-aligned
tensor parallelism (``mesh``)."""
