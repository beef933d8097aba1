"""Parallel paths of the port over ``torch.distributed`` (counterpart of
``segmif_tpu/parallel/``): ``dist`` (ranks, backends, collectives, the
spawn launcher), ``mesh`` (data parallelism: which batch rows a rank
owns, replicated weights), ``spatial`` (the fusion trunk row-sharded over
ranks) and ``dryrun`` (one step of each path on N ranks)."""
