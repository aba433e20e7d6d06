"""Document structure trees for the hierarchical strategy (copy of
``vnsum_tpu/text/tree.py``).

Node schema {type: Document|Header|Paragraph, text, children} and operations
match the reference's DFS helpers
(runners/run_summarization_ollama_mapreduce_hierarchical.py:202-239), plus a
loader for data_1/document_tree.json keyed by filename
(run_full_evaluation_pipeline.py:505-530).
"""
from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Callable, Optional

Node = dict


def depth_first_traverse(
    node: Node,
    callback: Callable[[Node, int, Optional[Node]], None],
    depth: int = 0,
    parent: Optional[Node] = None,
) -> None:
    callback(node, depth, parent)
    for child in node.get("children", []) or []:
        depth_first_traverse(child, callback, depth + 1, node)


def tree_depth(node: Node) -> int:
    children = node.get("children") or []
    if not children:
        return 0
    return 1 + max(tree_depth(c) for c in children)


def collect_nodes_at_depth(root: Node, target_depth: int) -> list[Node]:
    """Non-Paragraph nodes at exactly ``target_depth``."""
    out: list[Node] = []

    def _cb(n: Node, d: int, _p: Optional[Node]) -> None:
        if d == target_depth and n.get("type") != "Paragraph":
            out.append(n)

    depth_first_traverse(root, _cb)
    return out


def extract_descendant_paragraph_text(node: Node) -> str:
    """Concatenate all descendant Paragraph texts, joined by blank lines."""
    texts: list[str] = []

    def _cb(n: Node, _d: int, _p: Optional[Node]) -> None:
        if n.get("type") == "Paragraph":
            texts.append(n.get("text", ""))

    depth_first_traverse(node, _cb)
    return "\n\n".join(texts)


def replace_node_with_paragraph(node: Node, summary_text: str) -> None:
    """Mutate ``node`` in place into a Paragraph leaf holding ``summary_text``."""
    node.pop("children", None)
    node.clear()
    node["type"] = "Paragraph"
    node["text"] = summary_text


class DocumentTree:
    """Map of filename -> Document node, loaded from a tree JSON file."""

    def __init__(self, mapping: dict[str, Node]) -> None:
        self._trees = mapping

    @classmethod
    def load(cls, path: str | Path) -> "DocumentTree":
        data = json.loads(Path(path).read_text(encoding="utf-8"))
        if isinstance(data, list):
            mapping = {}
            for i, entry in enumerate(data):
                name = entry.get("filename") or entry.get("name")
                if not name:
                    raise ValueError(
                        f"tree JSON list entry {i} has no 'filename'/'name' key"
                    )
                mapping[name] = entry.get("tree", entry)
        else:
            mapping = data
        return cls(mapping)

    def get(self, filename: str) -> Optional[Node]:
        """Deep copy — strategies mutate trees in place during collapse."""
        node = self._trees.get(filename)
        return copy.deepcopy(node) if node is not None else None

    def __contains__(self, filename: str) -> bool:
        return filename in self._trees

    def __len__(self) -> int:
        return len(self._trees)
