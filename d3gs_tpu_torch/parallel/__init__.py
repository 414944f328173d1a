"""Multi-GPU training and rendering over `torch.distributed` (counterpart of
`d3gs_tpu/parallel/`): one process per rank, NCCL between CUDA devices,
gloo on the CPU and between ranks that share one card.

  mesh.py     the `Mesh` (1D, or cam x shard), the placement of the state
  comm.py     the collectives with their gradients, and a byte counter
  sharded.py  the sharded render and the three sharded steps

Two layouts of the flagship k-camera step (`--mesh_mode`), both equal to
the single-device step (tests/test_torch_port_parallel.py):

* camera (the default): every rank holds all N Gaussians and the deform
  net and renders k / D of the cameras with the single-device pipeline.
  One all-reduce per step sums the gradients: 4 B for each of the 59
  parameter floats of a Gaussian at SH degree 3 (236·N B), the 2 floats of
  its screen-space tap (8·N B) and the deform net's parameters (4·|MLP|
  B); then a max-reduce of the radii (4·N B) and a sum of three scalars.
  About 248·N + 4·|MLP| B per step at SH 3, whatever k. Memory does not
  shrink with D, and k must divide by D: a ragged batch is padded with
  repeated cameras weighted 1/copies, so the loss is the unpadded mean.
* gauss_tile: each rank holds N / D rows of every per-Gaussian tensor,
  Adam moments and densification statistics included, and the tile rows
  [r·t, (r + 1)·t) of every frame, t = ceil(tiles_y / D). Per camera it
  projects its rows, all-gathers them as one (N, 16) f32 record tensor
  (`ops/rasterize.py::pack_records_full`): 64·N B; the backward
  reduce-scatters the records' gradient, 64·N B again. The loss runs on
  strips: two halo exchanges of 5 rows (5·W·3·4 B each) per camera and
  direction, forward and backward, and a sum of 2 floats per camera; the
  ground truth's halo rows are read from the frame every rank holds. Then
  the deform gradients' all-reduce (4·|MLP| B). About 128·N·k B per step:
  fewer bytes than the camera layout only for k = 1, but the only layout
  whose memory shrinks with D, and any k works.
* gauss_tile on a (C x S) mesh (`--mesh_shape CxS`): the camera batch
  splits over the C camera groups, the gauss+tile layout runs inside each
  group of S ranks (128·N·k / C B per group), and the rows' gradients
  (244·N / S B), radii and loss are summed or max-reduced over the C ranks
  that hold the same rows.

The JAX step prefetched camera c + 1's gather while blending camera c (a
TPU pipelining device); here the gathers run in order, one per camera:
overlapping them with the blend is later work, and so is measuring any of
this across cards.
"""
