"""The plain reference that decides a run's `correct`.

Plain PyTorch and NumPy, written from the semantics of the reference
system and importing nothing of the program (kafka_ps_tpu_torch), of
jax or of the JAX package: the buffer policy (`buffer`), the rounds a
sequential run trains (`rounds`), what of the weights the check follows
(`follow`), and one module a model family (`mlp`, `logreg`: its k-step
local update and test metrics, on the arithmetic of `numerics`), which a
configuration names under `reference`.  It makes its own initial
weights and buffers from the inputs the harness hands both sides; what
the program made is only ever the thing judged.
"""
