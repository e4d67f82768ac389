"""Native (C++) components of the port (counterpart of
kafka_ps_tpu/native): the one-pass CSV → CSR parser of the streaming
producer, built with g++ at first use (binding.py).  Without a C++
compiler the producer parses in Python."""

from kafka_ps_tpu_torch.native.binding import (  # noqa: F401
    NativeCsv,
    is_available,
    parse_csv,
)
