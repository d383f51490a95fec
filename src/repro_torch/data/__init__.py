# Copy of src/repro/data/__init__.py.
from .pipeline import SyntheticTokens, FileTokens, Prefetcher, make_pipeline

__all__ = ["SyntheticTokens", "FileTokens", "Prefetcher", "make_pipeline"]
