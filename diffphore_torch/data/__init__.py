from .graphs import ComplexBatch, concat_batches, load_cached, repeat_batch

__all__ = ["ComplexBatch", "concat_batches", "load_cached", "repeat_batch"]
