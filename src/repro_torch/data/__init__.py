"""The token data pipeline (a copy of the reference package's
``data/pipeline.py``)."""
from .pipeline import DataConfig, TokenPipeline, write_token_file

__all__ = ["DataConfig", "TokenPipeline", "write_token_file"]
