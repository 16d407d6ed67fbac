from .pipeline import SyntheticTokenLoader, TokenBatcher, token_stream

__all__ = ["SyntheticTokenLoader", "TokenBatcher", "token_stream"]
