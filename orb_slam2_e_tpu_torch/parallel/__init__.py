"""Scale-out on PyTorch: B camera streams tracked in lock step
(`batched`), bundle adjustment with its observations sharded over a
`torch.distributed` process group (`dist_ba`), and the keyframe-sharded BoW
query (`dist_db`)."""
