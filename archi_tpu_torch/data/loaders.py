"""Extension → text extraction.

Copy of ``archi_tpu/data/loaders.py``.

Analog of the reference's loader map
(``src/data_manager/vectorstore/loader_utils.py:18,40,55``: Text / Python /
BSHTML / PyPDF LangChain loaders) without the LangChain dependency: plain
text family reads directly, HTML strips tags (bs4 when available, regex
fallback), PDF via pypdf when available (gated — not in the base image).
"""

from __future__ import annotations

import os
import re

TEXT_EXTENSIONS = {
    ".txt", ".md", ".markdown", ".rst", ".py", ".c", ".cc", ".cpp", ".h",
    ".hpp", ".java", ".js", ".ts", ".json", ".yaml", ".yml", ".toml", ".ini",
    ".cfg", ".sh", ".tex", ".csv", ".log", ".sql", ".go", ".rs",
}
HTML_EXTENSIONS = {".html", ".htm", ".xhtml"}
PDF_EXTENSIONS = {".pdf"}


def supported_extensions() -> set[str]:
    exts = TEXT_EXTENSIONS | HTML_EXTENSIONS
    try:
        import pypdf  # noqa: F401

        exts = exts | PDF_EXTENSIONS
    except ImportError:
        pass
    return exts


def html_to_text(html: str) -> str:
    try:
        from bs4 import BeautifulSoup

        soup = BeautifulSoup(html, "html.parser")
        for tag in soup(["script", "style", "noscript"]):
            tag.decompose()
        return re.sub(r"\n{3,}", "\n\n", soup.get_text("\n")).strip()
    except ImportError:  # regex fallback
        txt = re.sub(r"<(script|style)[^>]*>.*?</\1>", " ", html,
                     flags=re.S | re.I)
        txt = re.sub(r"<[^>]+>", " ", txt)
        txt = re.sub(r"\s+", " ", txt)
        return txt.strip()


def _pdf_to_text(path: str) -> str:
    import pypdf

    reader = pypdf.PdfReader(path)
    return "\n\n".join(page.extract_text() or "" for page in reader.pages)


def load_text(path: str) -> str:
    """File path → extracted text. Raises ValueError for unsupported types."""
    ext = os.path.splitext(path)[1].lower()
    if ext in HTML_EXTENSIONS:
        with open(path, encoding="utf-8", errors="replace") as f:
            return html_to_text(f.read())
    if ext in PDF_EXTENSIONS:
        try:
            return _pdf_to_text(path)
        except ImportError as e:
            raise ValueError(f"pdf support unavailable: {e}") from e
    if ext in TEXT_EXTENSIONS or ext == "":
        with open(path, encoding="utf-8", errors="replace") as f:
            return f.read()
    raise ValueError(f"unsupported extension: {ext}")
