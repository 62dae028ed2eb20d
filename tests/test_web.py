"""Web frontend: upload -> rotate -> artifacts over real HTTP."""

import pathlib
import threading
import urllib.request
import uuid

import pytest

from csa_jax.web import app as webapp

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    webapp.UPLOAD_DIR = str(tmp_path_factory.mktemp("uploads"))
    webapp.LOG_FILE = webapp.UPLOAD_DIR + "/requests.log"
    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), webapp.Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()


def test_upload_and_results(server):
    boundary = uuid.uuid4().hex
    fasta = (FIXTURES / "tiny" / "t1.txt").read_bytes()
    body = (
        f'--{boundary}\r\nContent-Disposition: form-data; '
        f'name="fastafile"; filename="t1.txt"\r\n'
        f"Content-Type: text/plain\r\n\r\n"
    ).encode() + fasta + (
        f"\r\n--{boundary}--\r\n"
    ).encode()
    req = urllib.request.Request(
        server + "/run",
        data=body,
        headers={
            "Content-Type": f"multipart/form-data; boundary={boundary}"
        },
    )
    text = urllib.request.urlopen(req, timeout=120).read().decode()
    assert "Results" in text
    assert "Download Rotated FASTA" in text
    # the block map is actually clickable: a real <map> with <area> tags
    # built from the imagemap data (reference index.php:383-405), whose
    # hrefs land on positions-table row anchors
    assert '<map name="blocksmap"' in text
    assert "<area " in text
    import re as _re

    hrefs = set(_re.findall(r'href="#(row\d+)"', text))
    ids = set(_re.findall(r'<tr id="(row\d+)"', text))
    assert hrefs and hrefs <= ids
    # the rotated-FASTA artifact downloads and carries the @ rotations
    import re

    m = re.search(r"/file\?t=([^&\"]+)&k=rotated", text)
    assert m
    rot = urllib.request.urlopen(
        server + f"/file?t={m.group(1)}&k=rotated", timeout=30
    ).read().decode()
    assert "@ 74" in rot  # s0's captured reference rotation


def test_form_page(server):
    page = urllib.request.urlopen(server + "/", timeout=30).read().decode()
    assert "fastafile" in page and "minblocksize" in page


def test_rejects_empty(server):
    req = urllib.request.Request(
        server + "/run", data=b"", headers={"Content-Type": "text/plain"}
    )
    try:
        urllib.request.urlopen(req, timeout=30)
        raised = False
    except urllib.error.HTTPError as e:
        raised = e.code == 400
    assert raised


def test_device_jobs_take_the_device_lock(tmp_path, monkeypatch):
    """Uploads large enough for `auto` to pick the device engine run
    their child under the device lock; small ones do not."""
    import subprocess

    from csa_jax.rotation import pipeline

    seen = []

    def fake_run(*a, **k):
        seen.append(webapp._DEVICE_LOCK.locked())
        raise subprocess.TimeoutExpired(a[0], 1)

    monkeypatch.setattr(subprocess, "run", fake_run)
    fasta = tmp_path / "s.fasta"
    fasta.write_text(">a\nACGTACGT\nACGT\n>b\nTTTT\n")
    assert webapp._sequence_chars(str(fasta)) == 16
    for threshold, locked in [("1000", False), ("10", True)]:
        monkeypatch.setenv("CSA_AUTO_DEVICE_MIN", threshold)
        want = pipeline.auto_may_use_device(16)
        with pytest.raises(ValueError):
            webapp.run_rotation_job(str(fasta))
        assert seen[-1] is want
        if locked:
            assert want
    assert not webapp._DEVICE_LOCK.locked()
