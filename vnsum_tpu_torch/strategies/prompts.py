"""Vietnamese prompt templates, verbatim from the reference (copy of the
map-reduce and truncated templates of ``vnsum_tpu/strategies/prompts.py``;
the other strategies' templates come with their ports).

Templates are plain ``str.format`` strings; no prompt-framework layer.
"""


def template_header(template: str) -> str:
    """The literal prefix of ``template`` before its first ``{placeholder}``
    — by construction a string prefix of every prompt formatted from it."""
    i = template.find("{")
    return template[:i] if i >= 0 else template


# map prompt — runners/run_summarization_ollama_mapreduce.py:80-85
MAPREDUCE_MAP = """Bạn là một chuyên gia tóm tắt nội dung.
Vui lòng viết một bản tóm tắt chi tiết cho đoạn văn bản sau bằng **tiếng Việt**.

{content}

Lưu ý: Không sử dụng dấu đầu dòng, hãy viết bằng câu đầy đủ và theo đoạn văn."""

# reduce prompt — runners/run_summarization_ollama_mapreduce.py:88-96
MAPREDUCE_REDUCE = """
Sau đây là một tập hợp các bản tóm tắt:
{docs}

Hãy tổng hợp và chắt lọc chúng thành một bản tóm tắt cuối cùng, toàn diện về các chủ đề chính bằng tiếng Việt.
Không sử dụng dấu đầu dòng, hãy viết bằng câu đầy đủ và theo đoạn văn.
"""

# single-shot truncated prompt (f-string incl. indentation) —
# runners/run_summarization_ollama.py:16-21
TRUNCATED = """
    Bạn là một chuyên gia tóm tắt nội dung.
    Vui lòng viết một bản tóm tắt chi tiết cho tài liệu sau bằng **tiếng Việt**.
    \n\n{text}.
    \n\nLưu ý: Không sử dụng dấu đầu dòng, hãy viết bằng câu đầy đủ và theo đoạn văn.
    """
