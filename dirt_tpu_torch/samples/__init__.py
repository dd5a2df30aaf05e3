"""The reference's sample programs on the port (PyTorch counterparts of
the repository's samples/): `python -m dirt_tpu_torch.samples.simple`,
`.deferred` and `.textured`.  Each renders its scene at 640x480, writes
it as a PPM into --out (default: the git-ignored samples/_out/ beside
this package's modules), and runs its short inverse-rendering fit at
160x120."""
