__all__ = ["ComplexBatch", "concat_batches", "load_cached", "repeat_batch"]


def __getattr__(name):
    # torch loads on first use: a featurization process imports
    # ``data.featurize`` and ``data.phore``, not torch
    if name in __all__:
        from . import graphs
        return getattr(graphs, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
