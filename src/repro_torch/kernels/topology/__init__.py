from .classify import leaf_classify_cuda, leaf_classify_plain

__all__ = ["leaf_classify_cuda", "leaf_classify_plain"]
