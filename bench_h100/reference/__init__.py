"""The plain reference the benchmark holds the port against.

Plain PyTorch, frozen copies of the rasteriser's semantics: scene math
(`scene`), triangle setup and fragment math (`geometry`), a brute-force
forward (`forward`), the plain scatter gradient (`gradient`) and the two
entry points under autograd (`autograd`).  It imports neither jax, the
JAX package nor anything of the PyTorch port, and takes nothing the port
made: every input comes from the benchmark's own inputs.
"""
