"""Google Drive downloads with the large-file confirm flow (counterpart of
``vince_tpu/scrape/drive.py``). A plain GET of ``uc?export=download`` returns
an HTML virus-scan page for files above the scan limit; ``drive_fetch``
follows that page's download form (``drive.usercontent.google.com/download``
with hidden id/export/confirm/uuid fields, or a relative action), or a legacy
``confirm=<token>`` link, then streams the payload to disk. A page with
neither raises ``OSError``. ``opener`` (anything with ``open(url)``) can be
given, and is by default a ``urllib`` opener with a cookie jar.
"""

import html
import http.cookiejar
import re
import shutil
import urllib.request
from typing import Optional
from urllib.parse import parse_qs, urlencode, urljoin, urlparse

_CHUNK = 1 << 20


def extract_drive_id(url: str) -> Optional[str]:
    """The Drive file id of a share, open or download URL, else None."""
    parsed = urlparse(url)
    if "drive.google.com" not in parsed.netloc and \
            "drive.usercontent.google.com" not in parsed.netloc:
        return None
    qs = parse_qs(parsed.query)
    if qs.get("id"):
        return qs["id"][0]
    m = re.search(r"/file/d/([0-9A-Za-z_-]+)", parsed.path)
    return m.group(1) if m else None


def _looks_like_html(first_bytes: bytes) -> bool:
    head = first_bytes[:512].lstrip().lower()
    return head.startswith(b"<!doctype html") or head.startswith(b"<html")


def _default_opener():
    return urllib.request.build_opener(
        urllib.request.HTTPCookieProcessor(http.cookiejar.CookieJar()))


def _save_stream(resp, first: bytes, dest: str) -> str:
    with open(dest, "wb") as f:
        f.write(first)
        shutil.copyfileobj(resp, f, _CHUNK)
    return dest


def drive_fetch(file_id: str, dest: str, opener=None) -> str:
    """The public Drive file ``file_id`` into ``dest``; raises ``OSError``
    where the confirm flow cannot reach the payload in three requests."""
    opener = opener or _default_opener()
    url = f"https://drive.google.com/uc?export=download&id={file_id}"
    for _ in range(3):
        resp = opener.open(url)
        try:
            first = resp.read(_CHUNK)
            if not _looks_like_html(first):
                return _save_stream(resp, first, dest)
            page = (first + resp.read()).decode("utf-8", "replace")
        finally:
            resp.close()
        # the interstitial's form: its action (maybe relative) and hidden fields
        m = re.search(r"<form[^>]+action=\"([^\"]+)\"", page)
        if m:
            action = urljoin(url, html.unescape(m.group(1)))
            fields = dict(re.findall(
                r"<input[^>]+name=\"([^\"]+)\"[^>]+value=\"([^\"]*)\"", page))
            fields.setdefault("id", file_id)
            fields.setdefault("export", "download")
            url = action + "?" + urlencode(fields)
            continue
        # a legacy page: the confirm token in a link (the cookie is already set)
        m = re.search(r"confirm=([0-9A-Za-z_-]+)", page)
        if m:
            url = (f"https://drive.google.com/uc?export=download"
                   f"&confirm={m.group(1)}&id={file_id}")
            continue
        raise OSError(f"Drive returned an HTML page with no download form for "
                      f"id={file_id} (file removed or quota exceeded?)")
    raise OSError(f"Drive confirm flow did not converge for id={file_id}")


def fetch_url(url: str, dest: str, opener=None) -> str:
    """Any URL into ``dest``; a Drive URL goes through ``drive_fetch``."""
    file_id = extract_drive_id(url)
    if file_id is not None:
        return drive_fetch(file_id, dest, opener=opener)
    opener = opener or _default_opener()
    resp = opener.open(url)
    try:
        return _save_stream(resp, b"", dest)
    finally:
        resp.close()
