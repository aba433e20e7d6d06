from .bpe import BPETokenizer
from .cleaning import clean_thinking_tokens
from .splitter import RecursiveTokenSplitter
from .tokenizer import (
    ByteTokenizer,
    HFTokenizer,
    Tokenizer,
    get_tokenizer,
    whitespace_token_count,
)
from .tree import (
    DocumentTree,
    collect_nodes_at_depth,
    depth_first_traverse,
    extract_descendant_paragraph_text,
    replace_node_with_paragraph,
    tree_depth,
)

__all__ = [
    "BPETokenizer",
    "clean_thinking_tokens",
    "RecursiveTokenSplitter",
    "ByteTokenizer",
    "HFTokenizer",
    "Tokenizer",
    "get_tokenizer",
    "whitespace_token_count",
    "DocumentTree",
    "collect_nodes_at_depth",
    "depth_first_traverse",
    "extract_descendant_paragraph_text",
    "replace_node_with_paragraph",
    "tree_depth",
]
