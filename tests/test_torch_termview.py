"""The port's in-terminal preview against ``flux_tpu.termview`` (the same
escapes for the same frame, in every mode), and the CLI's ``-g`` with
stdin not a TTY: the job path and the progressive path write
``<scene>-preview.png``, the frame of the PPM."""

import io

import numpy as np
import pytest
import yaml
from PIL import Image as PILImage

from flux_tpu import termview as j_termview
from flux_tpu_torch import cli, termview
from flux_tpu_torch.image import read_ppm
from tests.test_torch_job import tiny_doc


class FakeTty(io.StringIO):
    def __init__(self, tty=True):
        super().__init__()
        self._tty = tty

    def isatty(self):
        return self._tty


def frame(h=20, w=36, seed=5):
    img = np.random.default_rng(seed).random((h, w, 3), dtype=np.float32)
    img[: h // 2] *= np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :, None]
    return img


@pytest.mark.parametrize("env", [{}, {"TERM": "xterm-256color"}, {"TERM": "xterm-kitty"},
                                 {"KITTY_WINDOW_ID": "1", "TERM": "x"}, {"TERM": "dumb"}])
@pytest.mark.parametrize("tty", [True, False])
def test_detect_mode_matches(env, tty):
    assert termview.detect_mode(FakeTty(tty), env=env) == j_termview.detect_mode(FakeTty(tty), env=env)


@pytest.mark.parametrize("cols, rows", [(16, 6), (40, 20), (80, 24)])
def test_ansi_halfblock_matches(cols, rows):
    img = frame()
    assert termview.ansi_halfblock(img, cols, rows) == j_termview.ansi_halfblock(img, cols, rows)


@pytest.mark.parametrize("mode", ["ansi", "kitty", "auto"])
def test_term_preview_output_matches(mode):
    """Three frames with and without a status line: the streams are equal
    escape for escape (rewinds included)."""
    streams = []
    for mod in (termview, j_termview):
        out = FakeTty(tty=mode != "auto")
        tp = mod.TermPreview(stream=out, mode=mode, max_cols=24, max_rows=8)
        tp.update(frame(seed=1), status="pass 1/3")
        tp.update(frame(seed=2))
        tp.update(frame(seed=3), status="pass 3/3")
        tp.close()
        streams.append(out.getvalue())
    assert streams[0] == streams[1]
    assert (streams[0] == "") == (mode == "auto")


def _scene_file(tmp_path):
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(tiny_doc()))
    return path


@pytest.mark.parametrize("progressive", [False, True], ids=["job-path", "progressive"])
def test_cli_preview_writes_the_png_without_a_tty(tmp_path, capsys, progressive):
    argv = [str(_scene_file(tmp_path)), "-r", "2", "-d", "2", "-R", "4", "--device", "cpu",
            "--output-dir", str(tmp_path), "-g"] + (["--progressive", "2"] if progressive else [])
    ran = cli.run(argv)
    assert ran["out"] == str(tmp_path / "demo2.ppm")
    png = np.asarray(PILImage.open(tmp_path / "demo2-preview.png"), np.int32)
    img = read_ppm(ran["out"])
    levels = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.int32)
    assert png.shape == (12, 16, 3)
    assert np.abs(png - levels).max() <= 1  # the PPM's 16-bit levels, rounded to 8 bits
    out = capsys.readouterr().out
    assert ("pass done: 4/4 spp" in out) if progressive else (f"Wrote {tmp_path / 'demo2.ppm'}" in out)
