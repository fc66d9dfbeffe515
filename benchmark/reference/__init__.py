"""The plain reference: what each cell's timed path computes, written with
plain PyTorch operations from the published descriptions, with no kernel,
cache or batching trick, and importing nothing of the port. It runs in true
f32 with TF32 off, or in f64 where it judges an f32 program, and in the
lower precisions of `lowp` when it stands in as the control."""
