"""Tensor- and sequence-parallel serving over ``torch.distributed``
(port of the serving half of ``repro.distributed``): one process per
shard, every rank running the same ``ServingEngine`` (DESIGN.md §13-§14).

  * ``meshes`` — ``ServeMesh``: this rank's ``(sp, tp)`` coordinate and
    its two axis groups, built from an initialised default process group;
  * ``comm`` — the three collectives the sharded model runs (the
    counterparts of the ``psum`` / ``all_gather`` / ``ppermute`` that the
    reference's ``shard_map`` traces), each counted by kind;
  * ``sharding`` — the logical-axis rule tables, the sp prefill census,
    the divisibility preflight and ``shard_params``;
  * ``launch`` — spawning ``sp * tp`` ranks and the rank entry that
    serves a list of prompts.
"""
