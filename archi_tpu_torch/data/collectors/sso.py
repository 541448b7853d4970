"""Browser-driven SSO crawling (Selenium-gated).

Copy of ``archi_tpu/data/collectors/sso.py``.

Mechanism parity with the reference's ``SSOScraper``/``CERNSSOScraper``
(``src/data_manager/collectors/scrapers/integrations/sso_scraper.py:24,315``):
a real browser drives the authenticated crawl so JS-rendered pages and SSO
login forms work.  Selenium is not in this image, so the driver is fully
injectable — ``BrowserSSOScraper`` takes any object with the tiny driver
surface it uses (get / find_elements / page_source / title / quit), and
``firefox_driver_factory`` builds the reference's headless-Firefox setup
the moment ``selenium`` is installed.

The cookie-session variant (``scraper.py SSOScraper``) remains the
browser-free fallback for plain form/cookie SSO.
"""

from __future__ import annotations

import logging
import time
import urllib.parse
from typing import Callable, Optional

from archi_tpu_torch.data.persistence import PersistenceService
from archi_tpu_torch.data.resource import Resource, ResourceMetadata

logger = logging.getLogger(__name__)

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".gif", ".bmp", ".svg", ".ico",
              ".webp")


def selenium_available() -> bool:
    try:
        import selenium  # noqa: F401

        return True
    except ImportError:
        return False


def firefox_driver_factory(headless: bool = True):
    """The reference's driver setup (``sso_scraper.py:69-95``): headless
    Firefox with container-safe options.  Raises ImportError when selenium
    is absent (callers gate on ``selenium_available()``)."""
    from selenium import webdriver
    from selenium.webdriver.firefox.options import Options as FirefoxOptions

    opts = FirefoxOptions()
    if headless:
        opts.add_argument("--headless")
    opts.add_argument("--no-sandbox")
    opts.add_argument("--disable-dev-shm-usage")
    opts.add_argument("--disable-gpu")
    opts.add_argument("--window-size=1920,1080")
    driver = webdriver.Firefox(options=opts)
    driver.set_page_load_timeout(30)
    return driver


def form_login(username: str, password: str, *,
               user_selector: str = "input[name=username]",
               pass_selector: str = "input[name=password]",
               submit_selector: str = "button[type=submit]",
               wait: float = 2.0) -> Callable:
    """Generic SSO form login hook (the reference's per-site ``login()``
    overrides reduced to selector configuration)."""
    def do_login(driver, login_url: str) -> None:
        driver.get(login_url)
        time.sleep(wait)
        driver.find_elements("css selector", user_selector)[0].send_keys(
            username)
        driver.find_elements("css selector", pass_selector)[0].send_keys(
            password)
        driver.find_elements("css selector", submit_selector)[0].click()
        time.sleep(wait)

    return do_login


class BrowserSSOScraper:
    """BFS crawl of an SSO-protected site through a (headless) browser.

    Args:
      persistence: where harvested pages land (catalog-upserting).
      driver_factory: () -> driver; defaults to headless Firefox when
        selenium exists.
      login: optional (driver, start_url) -> None hook run before the crawl.
      site_type: 'generic' or 'mkdocs' (reference's nav-link prioritization).
    """

    def __init__(self, persistence: PersistenceService, *,
                 driver_factory: Optional[Callable] = None,
                 login: Optional[Callable] = None,
                 site_type: str = "generic",
                 max_depth: int = 2, max_pages: int = 200,
                 wait_time: float = 1.0):
        if driver_factory is None:
            if not selenium_available():
                raise ImportError(
                    "selenium is not installed; pass driver_factory= or use "
                    "the cookie-session SSOScraper (data/collectors/scraper.py)"
                )
            driver_factory = firefox_driver_factory
        self.persistence = persistence
        self.driver_factory = driver_factory
        self.login = login
        self.site_type = site_type
        self.max_depth = max_depth
        self.max_pages = max_pages
        self.wait_time = wait_time

    @staticmethod
    def _is_image(url: str) -> bool:
        return urllib.parse.urlparse(url).path.lower().endswith(IMAGE_EXTS)

    def _links(self, driver, base_url: str) -> list[str]:
        host = urllib.parse.urlparse(base_url).netloc
        if self.site_type == "mkdocs":
            anchors = driver.find_elements(
                "css selector", ".md-nav__link, .md-content a")
        else:
            anchors = driver.find_elements("tag name", "a")
        out = []
        for a in anchors:
            try:
                href = a.get_attribute("href")
            except Exception:
                continue
            if not href:
                continue
            href = href.split("#")[0]
            p = urllib.parse.urlparse(href)
            if p.scheme in ("http", "https") and p.netloc == host \
                    and not self._is_image(href):
                out.append(href)
        return out

    def crawl(self, start_url: str) -> list[str]:
        """→ resource hashes of harvested pages."""
        driver = self.driver_factory()
        hashes: list[str] = []
        try:
            if self.login is not None:
                self.login(driver, start_url)
            queue: list[tuple[str, int]] = [(start_url, 0)]
            visited: set[str] = set()
            while queue and len(visited) < self.max_pages:
                url, depth = queue.pop(0)
                if url in visited:
                    continue
                visited.add(url)
                try:
                    driver.get(url)
                    time.sleep(self.wait_time)
                    html = driver.page_source
                except Exception as e:
                    logger.warning("sso crawl failed for %s: %s", url, e)
                    continue
                name = urllib.parse.urlparse(url).path.strip("/") or "index"
                meta = ResourceMetadata(
                    display_name=name.replace("/", "_") + ".html",
                    source_type="sso", url=url, extension=".html",
                )
                hashes.append(self.persistence.persist_resource(
                    Resource(html, meta)))
                if depth < self.max_depth:
                    for link in self._links(driver, start_url):
                        if link not in visited:
                            queue.append((link, depth + 1))
        finally:
            try:
                driver.quit()
            except Exception:
                pass
        return hashes
