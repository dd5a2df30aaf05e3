"""The benchmark's entry points, one module a kind of step:
entries/<entry>.py serves the traffic mixes whose `entry` is <entry>.

The harness's step (harness/program.py) and the check
(harness/check.py) call these names of the module, and nothing else of
it:

  LEAVES     the names of its tensors that are gradient leaves beside
             the background, in the order the step makes them.
  draw(config, num_vertices, generator, device)
             its tensors from the seed's generator, drawn after the pose
             pool and before the loss weights: `background` [B, H, W, C]
             (the rasterised buffer's channels), every name of LEAVES,
             and any others.
  scene(clip, leaves, inputs)
             in the step's "scene" span, after the clip-space vertices:
             the per-vertex values it rasterises.
  rasterise(port, background, clip, values, faces, shade)
             in the "rasterise" span: its call into the port
             (dirt_tpu_torch); `shade(gbuffer)` runs its `shade` in the
             benchmark's "shader" span.
  shade(gbuffer, leaves)
             the shader, where its entry point takes one.
  reference(clip, leaves, inputs)
             the plain reference's pixels (bench_h100.reference, under
             autograd) of the same step, for the check.

`leaves` maps "background" and the names of LEAVES to the step's leaf
tensors; `inputs` is the cell's harness.inputs.Inputs (its `tensors`,
the mesh's per-vertex arrays in `mesh`, the faces).  A new entry point
is a new file here.
"""
