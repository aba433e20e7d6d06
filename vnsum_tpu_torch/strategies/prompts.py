"""Vietnamese prompt templates, verbatim from the reference (copy of
``vnsum_tpu/strategies/prompts.py``; the prompts are the product, preserved
exactly and cited per template).

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

# critique-variant map prompt — runners/..._critique.py:118-131
CRITIQUE_MAP = """Hãy tóm tắt những thông tin quan trọng từ đoạn văn bản sau bằng tiếng Việt.
        Lưu ý bao gồm đầy đủ các chi tiết quan trọng như sự kiện hay nhân vật, các chủ đề chính. Không bỏ sót thông tin quan trọng. Nên tóm tắt theo từng chương nếu có.

Chỉ viết nội dung tóm tắt. Không giải thích, không xin lỗi, không nói về quy trình.

Văn bản:
<content>
{content}
</content>

Tóm tắt:"""

# collapse/reduce prompt — runners/..._critique.py:134-149
CRITIQUE_REDUCE = """
Hãy kết hợp các bản tóm tắt được đánh dấu theo phần sau thành MỘT bản tóm tắt duy nhất bằng tiếng Việt.

Các bản tóm tắt theo phần:
<summary>
{docs}
</summary>

Yêu cầu tổng hợp: Tổng hợp các thông tin từ TẤT CẢ các phần theo trình tự logic. Tạo ra một câu chuyện/tóm tắt liền mạch, kết nối các phần với nhau. Bao gồm đầy đủ các chi tiết quan trọng như sự kiện, nhân vật, chủ đề chính. Không bỏ sót thông tin quan trọng từ bất kỳ phần nào. Giữ nguyên trình tự thời gian/logic nếu có.

Chỉ viết nội dung tóm tắt tổng hợp cuối cùng. Không đề cập đến các tag phần, không giải thích quy trình.

Tóm tắt tổng hợp:
"""

# critique prompt — runners/..._critique.py:152-170
CRITIQUE_CRITIQUE = """
So sánh bản tóm tắt với nội dung tham khảo. Có thông tin quan trọng nào bị thiếu hoặc sai không?
Các thông tin quan trọng bao gồm sự kiện hay nhân vật,các chủ đề chính. Không bỏ sót thông tin quan trọng.

Bản tóm tắt:
<summary>
{summary}
</summary>

Nội dung tham khảo:
<reference_content>
{original_chunks}
</reference_content>

Nếu không có vấn đề thì trả lời: "Không có vấn đề"
Nếu có vấn đề thì chỉ ra vấn đề cụ thể thật chi tiết và rõ ràng. không cần giải thích, không cần xin lỗi, không cần nói về quy trình.
Ví dụ: "Thiếu thông tin về sự kiện X", "Thiếu thông tin về nhân vật Y"
"""

# refine prompt — runners/..._critique.py:173-196
CRITIQUE_REFINE = """
Nhiệm vụ: Viết lại bản tóm tắt để khắc phục các vấn đề đã chỉ ra. Sử dụng nội dung tham khảo để bổ sung thông tin bị thiếu.

Bản tóm tắt hiện tại (cần sửa):
<summary>
{current_summary}
</summary>

Vấn đề cần khắc phục:
<critique>
{critique}
</critique>

Nội dung tham khảo (để bổ sung thông tin):
<reference_content>
{reference_content}
</reference_content>

Yêu cầu:
- Khắc phục TẤT CẢ các vấn đề đã chỉ ra trong phần critique
- Bổ sung thông tin bị thiếu từ nội dung tham khảo
- Giữ nguyên thông tin đúng đã có trong bản tóm tắt cũ
- Đảm bảo tóm tắt mới có đầy đủ thông tin và chính xác

Chỉ viết bản tóm tắt đã sửa. Không giải thích, không xin lỗi, không nói về quy trình.

Bản tóm tắt đã sửa:
"""

# accept-strings checked on the critique output — runners/..._critique.py:254
CRITIQUE_ACCEPT_STRINGS = ("không có vấn đề", "no issues")

# initial summary prompt — runners/..._iterative.py:106-119
ITERATIVE_INITIAL = """Bạn là một chuyên gia phân tích và tóm tắt thông tin.
Nhiệm vụ của bạn là đọc phần đầu tiên của một tài liệu dài và tạo ra một bản tóm tắt **nền tảng**.

Bản tóm tắt này phải nắm bắt được những ý chính, bối cảnh và các thông tin quan trọng nhất làm cơ sở cho việc xây dựng một bản tóm tắt toàn diện sau này. Hãy tập trung vào việc xác định các yếu tố cốt lõi (Ai, Cái gì, Khi nào, Ở đâu, Tại sao) được giới thiệu trong đoạn văn này.

Văn bản cần tóm tắt:
---
{context}
---

Bản tóm tắt nền tảng:
"""

# refine prompt — runners/..._iterative.py:121-145
ITERATIVE_REFINE = """
Bạn là một biên tập viên xuất sắc, chuyên tổng hợp và tinh chỉnh thông tin từ nhiều nguồn.
Nhiệm vụ của bạn là cập nhật và mở rộng một bản tóm tắt đã có với những thông tin mới.

Bản tóm tắt hiện có (tóm tắt các phần trước):
---
{existing_answer}
---

Thông tin mới cần tích hợp (từ phần văn bản tiếp theo):
---
{context}
---

Dựa vào thông tin mới, hãy **viết lại hoàn toàn** bản tóm tắt để tạo ra một phiên bản mới, mạch lạc và toàn diện hơn.

**Yêu cầu quan trọng:**
1.  **Tích hợp, không nối thêm:** Đừng chỉ viết thêm thông tin mới vào cuối. Hãy khéo léo lồng ghép các chi tiết mới vào bản tóm tắt hiện có, sắp xếp lại các câu và ý tưởng để tạo ra một dòng chảy tự nhiên.
2.  **Bảo toàn thông tin cốt lõi:** Đảm bảo rằng những điểm chính và bối cảnh quan trọng từ "Bản tóm tắt hiện có" không bị mất đi hoặc giảm nhẹ tầm quan trọng, trừ khi thông tin mới làm rõ hoặc thay đổi chúng một cách trực tiếp.
3.  **Tổng hợp và cân bằng:** Bản tóm tắt cuối cùng phải phản ánh một cách cân bằng toàn bộ nội dung đã biết cho đến nay, không thiên vị cho thông tin mới nhất.

Hãy viết bản tóm tắt tổng hợp cuối cùng bằng câu văn hoàn chỉnh, liền mạch thành một đoạn văn bằng tiếng Việt.

Bản tóm tắt tổng hợp cuối cùng:
"""

# single-shot truncated prompt (f-string incl. indentation) —
# runners/run_summarization_ollama.py:16-21
TRUNCATED = """
    Bạn là một chuyên gia tóm tắt nội dung.
    Vui lòng viết một bản tóm tắt chi tiết cho tài liệu sau bằng **tiếng Việt**.
    \n\n{text}.
    \n\nLưu ý: Không sử dụng dấu đầu dòng, hãy viết bằng câu đầy đủ và theo đoạn văn.
    """

# hierarchical map prompt — runners/..._hierarchical.py:83-103
HIERARCHICAL_MAP = (
    "Bạn là một chuyên gia tóm tắt nội dung. Hãy tóm tắt những thông tin quan trọng từ đoạn văn bản sau bằng tiếng Việt.\n"
    "Lưu ý bao gồm đầy đủ các chi tiết quan trọng như sự kiện hay nhân vật, các chủ đề chính. Không bỏ sót thông tin quan trọng. Nên tóm tắt theo từng chương nếu có."
    "<content>\n"
    "{content}\n\n"
    "</content>\n\n"
    "Chỉ viết nội dung tóm tắt. Không giải thích, không xin lỗi, không nói về quy trình.\n"
    "Tóm tắt:"
)

# hierarchical reduce prompt — runners/..._hierarchical.py:105-115
HIERARCHICAL_REDUCE = (
    "Sau đây là một tập hợp các bản tóm tắt:\n<docs>\n{docs}\n</docs>\n\n"
    "Hãy tổng hợp và chắt lọc chúng thành một bản tóm tắt cuối cùng bằng **tiếng Việt**\n"
    "Lưu ý bao gồm đầy đủ các chi tiết quan trọng như sự kiện hay nhân vật, các chủ đề chính. Không bỏ sót thông tin quan trọng."
    "Chỉ viết nội dung tóm tắt. Không giải thích, không xin lỗi, không nói về quy trình."
    "Không sử dụng dấu đầu dòng; hãy viết thành các câu hoàn chỉnh theo đoạn văn."
    "Tóm tắt mới:"
)

# Skeleton-of-Thought (arXiv 2307.15337) — no reference-runner counterpart:
# the outline/expand pair is new here, written in the same register as the
# reference prompts (full-sentence Vietnamese, no bullets in the output, no
# meta-talk). The outline asks for a NUMBERED skeleton because the strategy
# parses "1. ..." lines to build the expansion fan-out.
SKELETON_OUTLINE = """Bạn là một chuyên gia phân tích văn bản.
Hãy đọc tài liệu sau và lập một dàn ý gồm 3 đến 8 ý chính bao quát nội dung, mỗi ý trên một dòng theo định dạng "1. ...", "2. ...".
Mỗi ý chỉ viết ngắn gọn trong một câu. Chỉ viết dàn ý, không giải thích, không mở đầu.

Tài liệu:
{content}

Dàn ý:"""

SKELETON_EXPAND = """Bạn là một chuyên gia tóm tắt nội dung. Dựa trên tài liệu dưới đây, hãy viết một đoạn văn ngắn bằng **tiếng Việt** triển khai ý sau của bản tóm tắt.
Chỉ viết nội dung của đoạn văn, bằng câu đầy đủ, không sử dụng dấu đầu dòng, không giải thích, không nói về quy trình.

Ý cần triển khai:
{point}

Tài liệu:
{content}

Đoạn văn:"""

# final grammar/flow polish — runners/..._hierarchical.py:296-313
HIERARCHICAL_POLISH = (
    "Bạn là một biên tập viên chuyên nghiệp.\n"
    "Dưới đây là bản tóm tắt của một tài liệu:\n"
    "<summary>\n"
    "{summary}"
    "</summary>\n"
    "Hãy rà soát để sửa lỗi ngữ pháp và đảm bảo văn phong mạch lạc, rõ ràng. Không bỏ sót thông tin quan trọng.\n"
    "không cần giải thích, không cần xin lỗi, không cần nói về quy trình.\n"
    "Tóm tắt mới:\n"
)
