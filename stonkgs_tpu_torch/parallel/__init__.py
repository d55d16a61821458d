"""Parallelism of the port on ``torch.distributed``: the {data, model} mesh
(:mod:`.mesh`), the tensor-parallel KG table and decoders (:mod:`.tp`),
the multi-process launch (:mod:`.multihost`) and a multi-process dry run
(:mod:`.dryrun`)."""
