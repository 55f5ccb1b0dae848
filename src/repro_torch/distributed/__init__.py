"""Tensor- and sequence-parallel serving and sharded training over
``torch.distributed`` (port of ``repro.distributed``): one process per
shard, every rank running the same engine or train step (DESIGN.md
§13-§14; ``train.steps.make_sharded_train_step``).

  * ``meshes`` — ``ServeMesh`` (the serving ``(sp, tp)`` grid) and the
    general ``Mesh`` of named axes (``make_mesh``: one group an axis, the
    data axes together, the whole mesh), built from an initialised
    default process group;
  * ``comm`` — the collectives the sharded model and step run (the
    counterparts of the reference's ``psum`` / ``pmax`` / ``all_gather``
    / ``psum_scatter`` / ``ppermute``) and Megatron's autograd pair
    ``copy_to_group`` / ``reduce_from_group``, each counted by kind;
  * ``sharding`` — the logical-axis rule tables, ``auto_rules``, the
    censuses, the divisibility preflight, ``NamedSharding`` (and
    ``Pieces``, a dim cut segment by segment: the SSM's head groups),
    ``shard_params`` / ``unshard`` and the training model's
    ``TrainShard``;
  * ``zero`` — ZeRO-1's moment specs and slices;
  * ``compression`` — int8 gradient compression with error feedback;
  * ``pipeline`` — the GPipe pipeline over a ring of ranks;
  * ``launch`` — spawning ranks, and the rank entries that serve, train,
    run the pipeline and the compressed mean.
"""
