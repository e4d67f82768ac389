"""Compressed delta transport (codecs bf16 / int8 / topk:R, error-feedback
residuals, the host wire format) and the device training slab
(counterpart of kafka_ps_tpu/compress/__init__.py, the same exports)."""

from kafka_ps_tpu_torch.compress.codecs import (Codec, WeightsCompressor,
                                                decode_message_parts,
                                                get_codec, make_compressor)
from kafka_ps_tpu_torch.compress.feedback import ErrorFeedback
from kafka_ps_tpu_torch.compress.slab import (SLAB_DTYPES, QuantizedSlab,
                                              SlabStore, decode_x,
                                              dequantize_rows, quantize_rows)
from kafka_ps_tpu_torch.compress.wire import (CODEC_BF16, CODEC_INT8,
                                              CODEC_NONE, CODEC_TOPK,
                                              INT8_CHUNK, NONE, CodecSpec,
                                              parse_codec)

__all__ = [
    "Codec", "CodecSpec", "ErrorFeedback", "QuantizedSlab", "SlabStore",
    "SLAB_DTYPES", "WeightsCompressor",
    "CODEC_NONE", "CODEC_BF16", "CODEC_INT8", "CODEC_TOPK", "INT8_CHUNK",
    "NONE", "decode_message_parts", "decode_x", "dequantize_rows",
    "get_codec", "make_compressor", "parse_codec", "quantize_rows",
]
