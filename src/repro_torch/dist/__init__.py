"""Distribution utilities of the port: logical-axis sharding rules as
DTensor placements (``dist.sharding``) and compressed data-parallel
gradient synchronization over ``torch.distributed`` (``dist.compress``)."""
