"""The port's tfevents writer and ``write_scalar_logs`` against the JAX
package's: the same scalars give the same event file, byte for byte (the
wall time and the hostname pinned), and the same CSV."""

import os
import socket
import time

import pytest

from learningorchestra_tpu.services import monitoring as jax_monitoring
from learningorchestra_tpu.services import tfevents as jax_tfevents
from learningorchestra_tpu_torch.services import monitoring, tfevents

HISTORY = {
    "loss": [1.5, 0.9, 0.4],
    "accuracy": [0.5, 0.75, 0.9],
    "epoch_time": [2.0, 1.0],  # ragged on purpose
    "note": ["n/a", 1.0, 2.0],  # a value that is not a number is skipped
}


@pytest.fixture(autouse=True)
def pinned(monkeypatch):
    monkeypatch.setattr(socket, "gethostname", lambda: "host-a")
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)


@pytest.mark.parametrize("prefix", ["", "job1"])
def test_event_file_bytes_equal_jax(tmp_path, prefix):
    want = jax_tfevents.write_scalars(tmp_path / "jax", HISTORY,
                                      prefix=prefix)
    got = tfevents.write_scalars(tmp_path / "port", HISTORY, prefix=prefix)
    assert os.path.basename(got) == os.path.basename(want)
    assert open(got, "rb").read() == open(want, "rb").read()
    for crc_input in (b"", b"123456789", open(want, "rb").read()):
        assert tfevents._masked_crc(crc_input) == \
            jax_tfevents._masked_crc(crc_input)


def test_write_scalar_logs_equal_jax(tmp_path):
    n = monitoring.write_scalar_logs(str(tmp_path / "port"), HISTORY,
                                     prefix="fit")
    assert n == jax_monitoring.write_scalar_logs(str(tmp_path / "jax"),
                                                 HISTORY, prefix="fit") == 3
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
