"""Multi-GPU training: meshes, the sharding table with FSDP2 and tensor
parallelism, ring attention, sequence and pipeline parallelism (the port of
``videollamb_tpu/parallel``; one process a card under ``torchrun``)."""
