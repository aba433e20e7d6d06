from .cleaning import clean_thinking_tokens
from .splitter import RecursiveTokenSplitter
from .tokenizer import (
    ByteTokenizer,
    HFTokenizer,
    Tokenizer,
    get_tokenizer,
    whitespace_token_count,
)

__all__ = [
    "clean_thinking_tokens",
    "RecursiveTokenSplitter",
    "ByteTokenizer",
    "HFTokenizer",
    "Tokenizer",
    "get_tokenizer",
    "whitespace_token_count",
]
