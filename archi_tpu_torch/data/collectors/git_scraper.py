"""Git repository collection: clone, harvest docs + code, build blob URLs.

Copy of ``archi_tpu/data/collectors/git_scraper.py``.

Mirrors the reference's ``GitScraper``
(``src/data_manager/collectors/scrapers/integrations/git_scraper.py:23``,
``collect:94``): shallow-clone a repo, collect mkdocs/docs markdown and code
files, and attach web blob URLs so retrieved chunks link back to the source.
"""

from __future__ import annotations

import logging
import os
import subprocess
import tempfile
from typing import Optional

from archi_tpu_torch.data.loaders import supported_extensions
from archi_tpu_torch.data.persistence import PersistenceService
from archi_tpu_torch.data.resource import Resource, ResourceMetadata

logger = logging.getLogger(__name__)

DOC_DIRS = ("docs", "doc", "documentation")


def blob_url(repo_url: str, branch: str, rel_path: str) -> Optional[str]:
    base = repo_url.rstrip("/")
    if base.endswith(".git"):
        base = base[:-4]
    if "github.com" in base or "gitlab" in base:
        sep = "-/blob" if "gitlab" in base else "blob"
        return f"{base}/{sep}/{branch}/{rel_path}"
    return None


class GitScraper:
    def __init__(self, persistence: PersistenceService, *,
                 include_code: bool = True, max_file_bytes: int = 512_000):
        self.persistence = persistence
        self.include_code = include_code
        self.max_file_bytes = max_file_bytes

    def _clone(self, repo_url: str, dest: str, branch: Optional[str]) -> str:
        cmd = ["git", "clone", "--depth", "1"]
        if branch:
            cmd += ["--branch", branch]
        cmd += [repo_url, dest]
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        out = subprocess.run(
            ["git", "-C", dest, "rev-parse", "--abbrev-ref", "HEAD"],
            capture_output=True, text=True, check=True,
        )
        return out.stdout.strip()

    def collect(self, repo_url: str, *, branch: Optional[str] = None,
                work_dir: Optional[str] = None) -> list[str]:
        """Clone + persist doc/code files; returns resource hashes
        (reference collect:94)."""
        hashes: list[str] = []
        exts = supported_extensions()
        with tempfile.TemporaryDirectory(dir=work_dir) as tmp:
            dest = os.path.join(tmp, "repo")
            try:
                actual_branch = self._clone(repo_url, dest, branch)
            except Exception as e:
                logger.warning("git clone failed %s: %s", repo_url, e)
                return hashes
            for root, dirs, files in os.walk(dest):
                dirs[:] = [d for d in dirs if not d.startswith(".")]
                for f in files:
                    path = os.path.join(root, f)
                    rel = os.path.relpath(path, dest)
                    ext = os.path.splitext(f)[1].lower()
                    if ext not in exts:
                        continue
                    is_doc = any(rel.startswith(d + os.sep) or rel.startswith(d + "/")
                                 for d in DOC_DIRS) or ext in (".md", ".rst")
                    if not is_doc and not self.include_code:
                        continue
                    try:
                        if os.path.getsize(path) > self.max_file_bytes:
                            continue
                        with open(path, "rb") as fh:
                            content = fh.read()
                    except OSError:
                        continue
                    meta = ResourceMetadata(
                        display_name=rel,
                        source_type="git",
                        url=blob_url(repo_url, actual_branch, rel),
                        file_name=f,
                        extension=ext,
                        extra={"repo": repo_url, "branch": actual_branch,
                               "kind": "doc" if is_doc else "code"},
                    )
                    hashes.append(
                        self.persistence.persist_resource(Resource(content, meta))
                    )
        return hashes

    def collect_all_from_config(self, config: dict) -> list[str]:
        hashes = []
        for repo in config.get("repos", []) or []:
            if isinstance(repo, str):
                hashes.extend(self.collect(repo))
            else:
                hashes.extend(
                    self.collect(repo["url"], branch=repo.get("branch"))
                )
        return hashes
