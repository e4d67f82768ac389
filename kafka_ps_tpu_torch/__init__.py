"""kafka_ps_tpu_torch — the streaming parameter server in PyTorch, for an
NVIDIA H100.

The port of `kafka_ps_tpu` (JAX, the reference) module by module: each
file here is the counterpart of the file at the same path there.  The
package imports torch and numpy only — never jax, and nothing of
`kafka_ps_tpu` — so it runs where JAX is not installed.

Entry points run on CUDA unless the caller asks for the CPU
(`device="cpu"`, or `KPS_PLATFORM=cpu` in the environment); see
`utils.config.resolve_device`.  The worker's k-step local update, for
one worker or a gang of them, logreg or MLP, runs as a hand-written CUDA
kernel on the card (`ops/fused_update.py`, `ops/csrc/*.cu`) and as its
plain PyTorch version on CPU tensors.
"""
