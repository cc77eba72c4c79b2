"""The sharded run: the compiled engine's options and the split of the box
axis over the ranks of a torch.distributed process group
(parallel/compiled.py), with its halo exchange and collectives
(parallel/halo.py)."""
