"""The port's document trees (``vnsum_tpu_torch/text/tree.py``): the cases of
tests/test_text_tree.py, each also held against the JAX package's function
on the same tree."""
import copy
import json

import pytest

from vnsum_tpu.text import tree as jax_tree
from vnsum_tpu_torch.text import (
    DocumentTree,
    collect_nodes_at_depth,
    depth_first_traverse,
    extract_descendant_paragraph_text,
    replace_node_with_paragraph,
    tree_depth,
)


def make_tree():
    return {
        "type": "Document",
        "text": "Tài liệu",
        "children": [
            {
                "type": "Header",
                "text": "Chương 1",
                "children": [
                    {"type": "Paragraph", "text": "đoạn 1a"},
                    {"type": "Paragraph", "text": "đoạn 1b"},
                ],
            },
            {
                "type": "Header",
                "text": "Chương 2",
                "children": [{"type": "Paragraph", "text": "đoạn 2a"}],
            },
        ],
    }


def deep_tree():
    """Depth 3 with a sub-header, an empty header and a null children list."""
    t = make_tree()
    t["children"][1]["children"].append({"type": "Header", "text": "Mục 2.1", "children": [
        {"type": "Paragraph", "text": "đoạn 2.1a"}, {"type": "Paragraph"}]})
    t["children"].append({"type": "Header", "text": "Phụ lục", "children": None})
    return t


TREES = {"make_tree": make_tree, "deep_tree": deep_tree,
         "leaf": lambda: {"type": "Paragraph", "text": "x"}}


def test_depth():
    assert tree_depth(make_tree()) == 2
    assert tree_depth({"type": "Paragraph", "text": "x"}) == 0


@pytest.mark.parametrize("name", sorted(TREES))
def test_depth_matches_jax(name):
    assert tree_depth(TREES[name]()) == jax_tree.tree_depth(TREES[name]())


def test_collect_skips_paragraphs():
    t = make_tree()
    nodes = collect_nodes_at_depth(t, 1)
    assert [n["text"] for n in nodes] == ["Chương 1", "Chương 2"]
    assert collect_nodes_at_depth(t, 2) == []  # depth-2 nodes are Paragraphs


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_collect_matches_jax(depth):
    t = deep_tree()
    got = collect_nodes_at_depth(t, depth)
    assert got == jax_tree.collect_nodes_at_depth(deep_tree(), depth)
    # the nodes themselves, not copies: the strategy mutates them in place
    assert all(any(n is c for c in _all_nodes(t)) for n in got)


def test_traverse_order_matches_jax():
    def walk(fn, t):
        seen = []
        fn(t, lambda n, d, p: seen.append((n.get("text"), d, p and p.get("text"))))
        return seen

    assert walk(depth_first_traverse, deep_tree()) == walk(
        jax_tree.depth_first_traverse, deep_tree())


def test_extract_paragraph_text_order():
    assert (
        extract_descendant_paragraph_text(make_tree())
        == "đoạn 1a\n\nđoạn 1b\n\nđoạn 2a"
    )


@pytest.mark.parametrize("name", sorted(TREES))
def test_extract_matches_jax(name):
    assert extract_descendant_paragraph_text(TREES[name]()) == (
        jax_tree.extract_descendant_paragraph_text(TREES[name]()))


def test_replace_in_place():
    t = make_tree()
    node = t["children"][0]
    replace_node_with_paragraph(node, "tóm tắt chương 1")
    assert node == {"type": "Paragraph", "text": "tóm tắt chương 1"}
    assert t["children"][0] is node


def test_replace_matches_jax():
    got, want = deep_tree(), deep_tree()
    for t, fn in ((got, replace_node_with_paragraph), (want, jax_tree.replace_node_with_paragraph)):
        fn(t["children"][1], "tóm tắt")
        fn(t["children"][2], "phụ lục")
    assert got == want
    assert tree_depth(got) == 2


def test_document_tree_load_and_deepcopy(tmp_path):
    p = tmp_path / "tree.json"
    p.write_text(json.dumps({"doc1.txt": make_tree()}), encoding="utf-8")
    dt = DocumentTree.load(p)
    assert "doc1.txt" in dt and len(dt) == 1
    a = dt.get("doc1.txt")
    replace_node_with_paragraph(a, "mutated")
    b = dt.get("doc1.txt")
    assert b["type"] == "Document"  # original untouched
    assert dt.get("missing.txt") is None


LIST_FORM = [
    {"filename": "a.txt", "tree": make_tree()},
    {"name": "b.txt", "tree": deep_tree()},
    dict(copy.deepcopy(make_tree()), filename="c.txt"),  # the entry is the tree
]


@pytest.mark.parametrize("form", ["dict", "list"])
def test_document_tree_load_matches_jax(tmp_path, form):
    data = {"a.txt": make_tree(), "b.txt": deep_tree()} if form == "dict" else LIST_FORM
    p = tmp_path / "tree.json"
    p.write_text(json.dumps(data, ensure_ascii=False), encoding="utf-8")
    got, want = DocumentTree.load(p), jax_tree.DocumentTree.load(p)
    assert len(got) == len(want)
    for name in ("a.txt", "b.txt", "c.txt", "missing.txt"):
        assert (name in got) == (name in want)
        assert got.get(name) == want.get(name)
    # get() hands out a deep copy: the loaded tree never changes
    a = got.get("a.txt")
    a["children"][0]["children"][0]["text"] = "đã sửa"
    assert got.get("a.txt") == make_tree()


def test_list_entry_without_a_name_raises_as_in_jax(tmp_path):
    p = tmp_path / "tree.json"
    p.write_text(json.dumps([{"tree": make_tree()}]), encoding="utf-8")
    with pytest.raises(ValueError) as got:
        DocumentTree.load(p)
    with pytest.raises(ValueError) as want:
        jax_tree.DocumentTree.load(p)
    assert str(got.value) == str(want.value)


def _all_nodes(t):
    out = []
    depth_first_traverse(t, lambda n, d, p: out.append(n))
    return out
