"""PS101 positive fixture (store/ path, torch twin): the per-page apply
kernel's library is loaded inside the pin path — a build lookup on every
fault."""
from kafka_ps_tpu_torch.ops import _build


def apply_to_page(page_value, delta):
    lib = _build.load("page_apply.cu")
    return lib.apply(page_value, delta)
