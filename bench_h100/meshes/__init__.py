"""The benchmark's meshes, one module a kind: meshes/<kind>.py serves the
configurations whose `mesh.kind` is <kind>.

Each module has `make(mesh)`: from the configuration's `mesh` object, a
dict with `vertices` [V, 3] float32 and `faces` [F, 3] int32 (numpy), and
any per-vertex arrays of its own under names of its own (`uvs`, say),
which the cell's inputs carry to the entry point as tensors
(`harness.inputs.Inputs.mesh`).  A new kind is a new file here.
"""
