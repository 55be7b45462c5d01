"""Multi-GPU execution of the port through ``torch.distributed`` (the
counterpart of ``egopack_tpu/parallel``): one process per GPU, a
``(data, model)`` grid of ranks, data parallelism, tensor parallelism on the
TRN pooling MLP, prototype banks split by row, process-sharded loaders and
sharded validation."""
