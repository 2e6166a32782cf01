"""The port's Drive fetches and download tools against ``vince_tpu.scrape``'s,
offline: scripted openers (the same URLs requested, the same bytes saved),
``file://`` tars, stubbed searches; and the pretrained-weights tool down to a
checkpoint directory of the port that restores bit for bit."""

import csv
import io
import os
import signal
import socket
import tarfile
import urllib.request

import numpy as np
import pytest
import torch

from torch_port_offline import offline, one_cv2_thread  # noqa: F401  (fixtures)
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)
from vince_tpu.scrape import download_pretrained_weights as jweights
from vince_tpu.scrape import download_r2v2 as jr2v2
from vince_tpu.scrape import drive as jdrive
from vince_tpu.scrape import search_youtube_for_urls as jsearch
from vince_tpu_torch.scrape import download_pretrained_weights as tweights
from vince_tpu_torch.scrape import download_r2v2 as tr2v2
from vince_tpu_torch.scrape import drive as tdrive
from vince_tpu_torch.scrape import search_youtube_for_urls as tsearch
from vince_tpu_torch.utils import youtube_utils as tyt

_INTERSTITIAL = b"""<!DOCTYPE html><html><body>
<form id="download-form" action="https://drive.usercontent.google.com/download" method="get">
<input type="submit" value="Download anyway"/>
<input type="hidden" name="id" value="FILEID"/>
<input type="hidden" name="export" value="download"/>
<input type="hidden" name="confirm" value="t"/>
<input type="hidden" name="uuid" value="abc-123"/>
</form></body></html>"""
_RELATIVE = (b"<html><body><form id=\"download-form\" action=\"/download\" method=\"get\">"
             b"<input type=\"hidden\" name=\"confirm\" value=\"t\"/></form></body></html>")
_LEGACY = (b"<html><body><a href=\"/uc?export=download&amp;confirm=TOKEN123&amp;id=FILEID\">"
           b"Download anyway</a></body></html>")
_FORMLESS = b"<html><body>Quota exceeded</body></html>"


class _Response:
    def __init__(self, payload: bytes):
        self._buf = payload

    def read(self, n=-1):
        if n is None or n < 0:
            out, self._buf = self._buf, b""
        else:
            out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def close(self):
        pass


class ScriptedOpener:
    """Serves the payloads in order; records the URLs requested."""

    def __init__(self, payloads):
        self.payloads, self.urls = list(payloads), []

    def open(self, url):
        self.urls.append(url)
        return _Response(self.payloads.pop(0))


class DenyOpener:
    def open(self, url):
        raise OSError("no egress")


def test_the_guard_refuses_sockets_and_keeps_file_urls(tmp_path):
    for connect in (lambda: socket.create_connection(("127.0.0.1", 9)),
                    lambda: socket.getaddrinfo("localhost", 80),
                    lambda: socket.socket().connect(("127.0.0.1", 9))):
        with pytest.raises(OSError, match="offline test"):
            connect()
    path = tmp_path / "f.bin"
    path.write_bytes(b"local")
    with urllib.request.urlopen(path.as_uri()) as resp:
        assert resp.read() == b"local"
    assert tyt._downloader() is None
    assert 0 < signal.getitimer(signal.ITIMER_REAL)[0] <= 60


@pytest.mark.parametrize("url,want", [
    ("https://drive.google.com/open?id=AbC_-123", "AbC_-123"),
    ("https://drive.google.com/file/d/XyZ987/view?usp=sharing", "XyZ987"),
    ("https://drive.google.com/uc?export=download&id=Q", "Q"),
    ("https://drive.usercontent.google.com/download?id=R&export=download", "R"),
    ("https://drive.google.com/drive/folders/abc", None),
    ("https://example.com/shard.tar", None),
    ("file:///data/shard.tar", None),
])
def test_extract_drive_id_matches_jax(url, want):
    assert tdrive.extract_drive_id(url) == jdrive.extract_drive_id(url) == want


@pytest.mark.parametrize("pages", [
    [b"\x00tar-bytes" * 10],
    [_INTERSTITIAL, b"REAL-TAR-PAYLOAD"],
    [_RELATIVE, b"PAYLOAD"],
    [_LEGACY, b"LEGACY-PAYLOAD"],
    [b"  <HTML><body>" + _LEGACY[12:], b"x" * (3 << 20)],  # a payload of three chunks
], ids=["direct", "form", "relative action", "legacy token", "chunks"])
def test_drive_fetch_requests_what_jax_requests(tmp_path, pages):
    saved = {}
    for label, mod in (("port", tdrive), ("jax", jdrive)):
        opener = ScriptedOpener(pages)
        dest = str(tmp_path / f"{label}.tar")
        assert mod.drive_fetch("FILEID", dest, opener=opener) == dest
        saved[label] = (opener.urls, open(dest, "rb").read())
    assert saved["port"] == saved["jax"]
    assert saved["port"][1] == pages[-1]
    assert saved["port"][0][0] == "https://drive.google.com/uc?export=download&id=FILEID"


@pytest.mark.parametrize("pages,match", [
    ([_FORMLESS], "no download form"),
    ([_LEGACY, _LEGACY, _LEGACY], "did not converge"),
], ids=["formless", "three pages"])
def test_drive_fetch_raises_as_jax_does(tmp_path, pages, match):
    for mod in (tdrive, jdrive):
        opener = ScriptedOpener(pages)
        with pytest.raises(OSError, match=match):
            mod.drive_fetch("FILEID", str(tmp_path / "out.tar"), opener=opener)


def test_fetch_url_goes_through_drive_or_straight(tmp_path):
    for mod in (tdrive, jdrive):
        opener = ScriptedOpener([_INTERSTITIAL, b"DRIVE", b"PLAIN"])
        mod.fetch_url("https://drive.google.com/open?id=FILEID", str(tmp_path / "a"), opener)
        mod.fetch_url("https://example.com/x.tar", str(tmp_path / "b"), opener)
        assert (tmp_path / "a").read_bytes() == b"DRIVE"
        assert (tmp_path / "b").read_bytes() == b"PLAIN"
        assert opener.urls[-1] == "https://example.com/x.tar"


def test_the_default_opener_fetches_a_file_url(tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(b"bytes of a shard")
    tdrive.fetch_url(src.as_uri(), str(tmp_path / "dst.bin"))
    assert (tmp_path / "dst.bin").read_bytes() == b"bytes of a shard"


def test_download_pretrained_weights_offline(monkeypatch, tmp_path):
    for mod, tool in ((tdrive, tweights), (jdrive, jweights)):
        monkeypatch.setattr(mod, "_default_opener", DenyOpener)
        with pytest.raises(SystemExit, match="download failed"):
            tool.main(["--backbone", "ResNet18", "--output-path", str(tmp_path / "out")])


@pytest.mark.parametrize("backbone", ["ResNet18", "ResNet50"])
def test_download_pretrained_weights_refuses_a_page_for_a_tar(monkeypatch, tmp_path, backbone):
    """A payload that is no tar ends the run with JAX's message; both tools
    request the same published Drive id."""
    for label, mod, tool in (("port", tdrive, tweights), ("jax", jdrive, jweights)):
        opener = ScriptedOpener([b"not a tar at all" * 64])
        monkeypatch.setattr(mod, "_default_opener", lambda opener=opener: opener)
        with pytest.raises(SystemExit, match="is not a tar"):
            tool.main(["--backbone", backbone, "--output-path", str(tmp_path / label)])
        assert opener.urls == [f"https://drive.google.com/uc?export=download&id="
                               f"{jweights.DRIVE_IDS[backbone]}"]
    assert tweights.DRIVE_IDS == jweights.DRIVE_IDS


def _tar_bytes(members):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def test_download_pretrained_weights_without_a_checkpoint_in_the_tar(monkeypatch, tmp_path):
    payload = _tar_bytes({"vince_r18/readme.txt": b"no weights here"})
    for label, mod, tool in (("port", tdrive, tweights), ("jax", jdrive, jweights)):
        monkeypatch.setattr(mod, "_default_opener", lambda: ScriptedOpener([payload]))
        with pytest.raises(SystemExit, match="no torch checkpoint found"):
            tool.main(["--output-path", str(tmp_path / label)])


def _reference_weights(seed=0, backbone="ResNet18", embed=64):
    from vince_tpu_torch.models.vince_model import VinceEncoder
    from vince_tpu_torch.utils.torch_convert import export_vince_state_dict

    encoder = VinceEncoder(backbone, embed)
    encoder.reset_parameters(torch.Generator().manual_seed(seed))
    return encoder, export_vince_state_dict(encoder.state_dict())


def test_download_pretrained_weights_converts_into_a_port_checkpoint(monkeypatch, tmp_path):
    """The interstitial, then a tar of a ResNet18 ``VinceModel`` state dict:
    the extracted file goes through the convert tool into a checkpoint
    directory whose encoder is the state dict's, bit for bit; the tar is
    removed; ``--skip-convert`` stops after the extraction."""
    from vince_tpu_torch.utils.checkpoint import read_pretrain_encoder
    from vince_tpu_torch.utils.torch_convert import export_vince_state_dict

    encoder, state_dict = _reference_weights()
    buf = io.BytesIO()
    torch.save(state_dict, buf)
    payload = _tar_bytes({"vince_r18/vince_weights.pt": buf.getvalue()})
    pages = [_INTERSTITIAL.replace(b"FILEID", tweights.DRIVE_IDS["ResNet18"].encode()), payload]
    openers = []

    def opener():
        openers.append(ScriptedOpener(pages))
        return openers[-1]

    monkeypatch.setattr(tdrive, "_default_opener", opener)
    out = tmp_path / "pretrained"
    assert tweights.main(["--output-path", str(out), "--skip-convert"]) is None
    assert sorted(os.listdir(out)) == ["vince_r18"]
    ckpt = tweights.main(["--output-path", str(out)])
    assert ckpt == str(out / "checkpoint_resnet18")
    assert openers[0].urls[1].startswith("https://drive.usercontent.google.com/download?")
    assert not any(name.endswith(".tar") for name in os.listdir(out))
    assert os.listdir(ckpt) == ["0"]
    tensors = read_pretrain_encoder(ckpt)
    restored = export_vince_state_dict(tensors)
    assert set(restored) == set(state_dict)
    for name, value in state_dict.items():
        assert restored[name].dtype == value.dtype, name
        assert torch.equal(restored[name], value), name
    # a second run converts the extracted file again, not the checkpoint it wrote
    assert tweights.main(["--output-path", str(out)]) == ckpt
    again = read_pretrain_encoder(ckpt)
    assert set(again) == set(tensors) and all(torch.equal(again[k], tensors[k]) for k in tensors)


def _shard_tree(root, shard):
    """A shard's members: two videos' frames in the cache layout."""
    members = {}
    for v in range(2):
        vid = f"S{shard}video{v:04d}"
        for f in range(3):
            members[f"train/{vid[:2]}/{vid}_{f:06d}.jpg"] = bytes([shard, v, f]) * 7
    return members


def test_download_r2v2_matches_jax_and_passes_over_bad_shards(tmp_path, capsys):
    tars = tmp_path / "remote"
    tars.mkdir()
    urls = []
    for shard in range(3):
        (tars / f"{shard}.tar").write_bytes(_tar_bytes(_shard_tree(tmp_path, shard)))
        urls.append((tars / f"{shard}.tar").as_uri())
    (tars / "evil.tar").write_bytes(_tar_bytes({"../escaped.jpg": b"x"}))
    (tars / "page.tar").write_bytes(b"<html>not a tar</html>")
    lines = [f"a {urls[0]}", "", f"b {urls[1]}", "c not-a-url", f"d {(tars / 'page.tar').as_uri()}",
             (tars / "evil.tar").as_uri(), f"{(tars / 'missing.tar').as_uri()}", urls[2]]
    urls_file = tmp_path / "urls.txt"
    urls_file.write_text("\n".join(lines) + "\n")
    trees = {}
    for label, tool in (("port", tr2v2), ("jax", jr2v2)):
        out = tmp_path / label
        tool.main(["--urls-file", str(urls_file), "--output-path", str(out)])
        trees[label] = {os.path.relpath(os.path.join(dp, f), out):
                        open(os.path.join(dp, f), "rb").read()
                        for dp, _, fs in os.walk(out) for f in fs}
        printed = capsys.readouterr().out
        assert "4/7 shards failed: ['c', 'd', '0004', '0005']" in printed
    assert trees["port"] == trees["jax"]
    want = {}
    for shard in range(3):
        want.update(_shard_tree(tmp_path, shard))
    assert trees["port"] == want  # no tar left, nothing outside the output
    assert not (tmp_path / "escaped.jpg").exists()


def test_download_r2v2_reads_the_published_url_list_format():
    from vince_tpu_torch.utils.util_functions import INFO_FILES_DIR

    with open(os.path.join(INFO_FILES_DIR, "r2v2_drive_urls.txt")) as f:
        rows = [line.split() for line in f if line.strip()]
    assert rows and all(len(r) == 2 and tdrive.extract_drive_id(r[1]) for r in rows)


@pytest.mark.parametrize("source", ["queries-file", "wordnet"])
def test_search_youtube_for_urls_matches_jax(monkeypatch, tmp_path, source):
    """Stubbed searches (the ids a query gives follow from the query, with
    repeats across queries): the same train and val CSVs as JAX's. Without
    ``--queries-file`` the queries are the WordNet table's names."""
    searched = []

    def search(query, max_results=50, **kw):
        searched.append(query)
        h = sum(map(ord, query))
        return [f"{(h * 31 + i * 7) % 997:011d}" for i in range(max_results % 5 + 3)]

    monkeypatch.setattr(tyt, "search_youtube", search)
    monkeypatch.setattr(jsearch, "search_youtube", search)
    monkeypatch.setattr(tsearch, "VAL_SIZE", 40)
    monkeypatch.setattr(jsearch, "VAL_SIZE", 40)
    if source == "wordnet":
        # the table's 76,003 names, searched by a stub: cut the pool to 2 threads
        argv = ["--num-workers", "2"]
    else:
        queries = tmp_path / "queries.txt"
        queries.write_text("\n".join(f"category {i}" for i in range(60)) + "\n\n")
        argv = ["--queries-file", str(queries), "--num-workers", "2"]
    out = {}
    for label, tool in (("port", tsearch), ("jax", jsearch)):
        searched.clear()
        tool.main(argv + ["--output-dir", str(tmp_path / label), "--results-per-query", "6"])
        out[label] = {name: list(csv.reader(open(tmp_path / label / f"{name}_ids.csv")))
                      for name in ("train", "val")}
        out[label + " queries"] = sorted(searched)
    assert out["port"] == out["jax"] and out["port queries"] == out["jax queries"]
    assert len(out["port"]["val"]) == 40 and out["port"]["train"]
    ids = [r[0] for split in ("train", "val") for r in out["port"][split]]
    assert len(ids) == len(set(ids))
    if source == "wordnet":
        assert len(out["port queries"]) == 76003


def test_search_youtube_for_urls_without_queries(monkeypatch, tmp_path):
    empty = tmp_path / "empty.txt"
    empty.write_text("\n")
    for tool in (tsearch, jsearch):
        with pytest.raises(SystemExit, match="no queries"):
            tool.main(["--queries-file", str(empty), "--output-dir", str(tmp_path)])
    assert np.all([not (tmp_path / f).exists() for f in ("train_ids.csv", "val_ids.csv")])
