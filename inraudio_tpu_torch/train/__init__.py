from .multi_inr import (MultiINRConfig, batched_chunk_eval, chunk_eval_fn,
                        chunk_signal, decode_chunk_range, stitch_chunks)

__all__ = ["MultiINRConfig", "batched_chunk_eval", "chunk_eval_fn",
           "chunk_signal", "decode_chunk_range", "stitch_chunks"]
