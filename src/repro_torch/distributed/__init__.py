"""The distributed runtime of the port: the sharded search over a
`torch.distributed` process group (`ulisse`) and its collectives
(`collectives`).  One rank per shard, SPMD: every rank builds its own
rows' index and runs the same scan, and the ranks meet only in the
collectives."""
