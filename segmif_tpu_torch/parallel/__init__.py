"""Parallel paths of the port over ``torch.distributed`` (counterpart of
``segmif_tpu/parallel/``): ``dist`` (ranks, backends, collectives, the
spawn launcher), ``mesh`` (the data x model mesh: which batch rows a rank
owns, replicated weights, the tensor-parallel split rule), ``tensor``
(the model split over a model group: the Megatron primitives, the split
MiT blocks and FFM weights, whole state dicts), ``spatial`` (the fusion
trunk row-sharded over ranks) and ``dryrun`` (one step of each path on N
ranks)."""
