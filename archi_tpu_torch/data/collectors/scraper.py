"""Web link scraper: BFS crawl with same-hostname expansion.

Copy of ``archi_tpu/data/collectors/scraper.py``.

Mirrors the reference's ``LinkScraper``/``ScraperManager``
(``src/data_manager/collectors/scrapers/scraper.py:14`` with ``crawl_iter:144``,
``scraper_manager.py:21,69-158``): requests + BeautifulSoup, same-hostname
link expansion, depth and max-page limits.  Selenium-driven SSO crawling is
represented by ``SSOScraper`` (cookie-session based here — this image has no
browser; the reference uses Selenium, ``sso_scraper.py:24``).
"""

from __future__ import annotations

import logging
import urllib.parse
from collections import deque
from typing import Callable, Optional

from archi_tpu_torch.data.loaders import html_to_text
from archi_tpu_torch.data.persistence import PersistenceService
from archi_tpu_torch.data.resource import Resource, ResourceMetadata

logger = logging.getLogger(__name__)


def _extract_links(html: str, base_url: str) -> list[str]:
    try:
        from bs4 import BeautifulSoup

        soup = BeautifulSoup(html, "html.parser")
        hrefs = [a.get("href") for a in soup.find_all("a") if a.get("href")]
    except ImportError:
        import re

        hrefs = re.findall(r'href=["\']([^"\'#]+)', html)
    out = []
    for h in hrefs:
        u = urllib.parse.urljoin(base_url, h.split("#")[0])
        if u.startswith(("http://", "https://")):
            out.append(u)
    return out


class LinkScraper:
    def __init__(
        self,
        *,
        max_depth: int = 2,
        max_pages: int = 100,
        same_hostname: bool = True,
        timeout: float = 15.0,
        session=None,
        fetcher: Optional[Callable[[str], str]] = None,
    ):
        self.max_depth = max_depth
        self.max_pages = max_pages
        self.same_hostname = same_hostname
        self.timeout = timeout
        self._session = session
        self._fetcher = fetcher  # injectable for tests / SSO sessions

    def _fetch(self, url: str) -> Optional[str]:
        if self._fetcher:
            return self._fetcher(url)
        import requests

        sess = self._session or requests
        try:
            r = sess.get(url, timeout=self.timeout)
            r.raise_for_status()
            ctype = r.headers.get("content-type", "")
            if "text" not in ctype and "html" not in ctype and ctype:
                return None
            return r.text
        except Exception as e:
            logger.warning("fetch failed %s: %s", url, e)
            return None

    def crawl_iter(self, seed_url: str):
        """BFS yield of (url, html, depth) (reference crawl_iter:144)."""
        seen = {seed_url}
        queue = deque([(seed_url, 0)])
        host = urllib.parse.urlparse(seed_url).hostname
        pages = 0
        while queue and pages < self.max_pages:
            url, depth = queue.popleft()
            html = self._fetch(url)
            if html is None:
                continue
            pages += 1
            yield url, html, depth
            if depth >= self.max_depth:
                continue
            for link in _extract_links(html, url):
                if link in seen:
                    continue
                if self.same_hostname and \
                        urllib.parse.urlparse(link).hostname != host:
                    continue
                seen.add(link)
                queue.append((link, depth + 1))


class ScraperManager:
    """Runs scrapers over configured links and persists pages as resources
    (reference scraper_manager.py:69-158)."""

    def __init__(self, persistence: PersistenceService, **scraper_kw):
        self.persistence = persistence
        self.scraper_kw = scraper_kw

    def collect_url(self, url: str, *, depth: Optional[int] = None,
                    fetcher=None) -> list[str]:
        kw = dict(self.scraper_kw)
        if depth is not None:
            kw["max_depth"] = depth
        if fetcher is not None:
            kw["fetcher"] = fetcher
        scraper = LinkScraper(**kw)
        hashes = []
        for page_url, html, _d in scraper.crawl_iter(url):
            text = html_to_text(html)
            if not text.strip():
                continue
            meta = ResourceMetadata(
                display_name=page_url, source_type="links", url=page_url,
                extension=".txt",
            )
            hashes.append(
                self.persistence.persist_resource(Resource(text, meta))
            )
        return hashes

    def collect_all_from_config(self, config: dict) -> list[str]:
        hashes = []
        for url in config.get("links", []) or []:
            hashes.extend(self.collect_url(url))
        return hashes


class SSOScraper(LinkScraper):
    """Authenticated crawl via a cookie/session login hook (reference uses
    Selenium, ``sso_scraper.py:24,315``; this variant drives a requests
    session that a deployment-specific ``login_fn`` authenticates)."""

    def __init__(self, login_fn: Optional[Callable] = None, **kw):
        import requests

        session = requests.Session()
        if login_fn:
            login_fn(session)
        super().__init__(session=session, **kw)
