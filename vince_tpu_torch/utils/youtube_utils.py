"""YouTube downloads and searches (counterpart of
``vince_tpu/utils/youtube_utils.py``), through ``yt-dlp`` or ``youtube-dl``
where one is on ``PATH``. Without one, or when the tool fails or runs out of
time (300 s a download, 600 s a search), ``download_video`` returns None and
``search_youtube`` []: the video cacher records that video as a failed
download."""

import os
import shutil
import subprocess
import tempfile
from typing import List, Optional


def get_video_url(video_id: str) -> str:
    return f"https://www.youtube.com/watch?v={video_id}"


def _downloader() -> Optional[str]:
    for exe in ("yt-dlp", "youtube-dl"):
        if shutil.which(exe):
            return exe
    return None


def download_video(video_id: str, video_path: Optional[str] = None,
                   cookie_path: str = "", max_height: int = 360,
                   timeout: int = 300) -> Optional[str]:
    """The video at most ``max_height`` rows high into ``video_path`` (by
    default ``downloaded_videos`` in the temporary directory); its file's
    path, or None on failure."""
    exe = _downloader()
    if exe is None:
        print("youtube download unavailable: install yt-dlp (offline environment?)")
        return None
    video_path = video_path or os.path.join(tempfile.gettempdir(), "downloaded_videos")
    os.makedirs(video_path, exist_ok=True)
    cmd = [
        exe, get_video_url(video_id),
        "-f", f"mp4[height<={max_height}]/best[height<={max_height}]/best",
        "-o", os.path.join(video_path, f"{video_id}.%(ext)s"), "--no-playlist", "--quiet",
    ]
    if cookie_path:
        cmd += ["--cookies", cookie_path]
    try:
        subprocess.run(cmd, check=True, timeout=timeout,
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return None
    for ext in ("mp4", "mkv", "webm"):
        path = os.path.join(video_path, f"{video_id}.{ext}")
        if os.path.exists(path):
            return path
    return None


def search_youtube(query: str, max_results: int = 50, cc_only: bool = True,
                   max_minutes: int = 4) -> List[str]:
    """The ids of up to ``max_results`` videos for ``query``: Creative Commons
    only and shorter than ``max_minutes`` by default; [] on failure."""
    exe = _downloader()
    if exe is None:
        print("youtube search unavailable: install yt-dlp (offline environment?)")
        return []
    search = f"ytsearch{max_results}:{query}" + (", creative commons" if cc_only else "")
    cmd = [exe, search, "--get-id", "--flat-playlist", "--quiet"]
    if max_minutes:
        cmd += ["--match-filter", f"duration < {max_minutes * 60}"]
    try:
        out = subprocess.run(cmd, check=True, capture_output=True, text=True,
                             timeout=600).stdout
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]
