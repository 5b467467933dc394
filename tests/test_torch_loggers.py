"""The port's loggers' options against the JAX package's on the CPU:
FileLogger's tensorboard mirror (the event files' scalars read back),
``save_images`` and ``async_saves``, and WandbLogger's calls into a stub
``wandb`` module put in ``sys.modules`` (wandb is not installed here), for
the same log records and a context that stands in for a real one."""
import json
import struct
import sys
import types

import numpy as np
import pytest
from PIL import Image

from segmentation_pipeline_tpu.loggers import FileLogger as JFileLogger
from segmentation_pipeline_tpu.loggers import WandbLogger as JWandbLogger
from segmentation_pipeline_torch import FileLogger, WandbLogger
from segmentation_pipeline_torch.evaluators import Table


class FakeContext:
    """What the loggers read of a context, and a save that writes a file."""

    def __init__(self, source):
        self.name = "fake"
        self.metadata = {}
        self.file_paths = [str(source)]

    def get_config(self):
        return {"model": {"filters": 4}}

    def save(self, path, **kwargs):
        with open(path, "w") as f:
            f.write("checkpoint")


def _records():
    image = Image.fromarray(np.arange(48, dtype=np.uint8).reshape(6, 8))
    return [{"iteration": 0, "loss": 0.5, "eval": {"dice": np.float32(0.25), "n": 3},
             "contour": {"image": image}},
            {"iteration": 1, "loss": 0.25, "note": "text"}]


def _scalars(folder):
    """(tag, step, value) of every scalar in the tensorboard event files
    under ``folder``."""
    from tensorboardX.proto.event_pb2 import Event

    out = []
    for path in sorted(folder.rglob("events.out.tfevents.*")):
        data = path.read_bytes()
        offset = 0
        while offset < len(data):
            (length,) = struct.unpack_from("<Q", data, offset)
            event = Event.FromString(data[offset + 12:offset + 12 + length])
            offset += 12 + length + 4
            out += [(v.tag, event.step, v.simple_value) for v in event.summary.value]
    return sorted(out)


@pytest.mark.parametrize("save_images", [True, False])
def test_file_logger_options_match_jax(tmp_path, save_images):
    runs = {}
    for name, cls in (("jax", JFileLogger), ("port", FileLogger)):
        logger = cls(str(tmp_path / name), use_tensorboard=True, save_images=save_images,
                     async_saves=False)
        logger.setup(FakeContext(__file__))
        for record in _records():
            logger.log(record)
        path = logger.save_context(FakeContext(__file__), "checkpoints", 7)
        assert path.read_text() == "checkpoint"  # written before save_context returned
        assert logger._save_executor is None
        logger.close()
        runs[name] = logger.run_dir
    port, jax = runs["port"], runs["jax"]
    scalars = _scalars(port / "tb")
    assert scalars == _scalars(jax / "tb")
    assert ("eval.dice", 0, 0.25) in scalars and ("loss", 1, 0.25) in scalars
    images = sorted(p.name for p in (port / "images").glob("*.png")) if save_images else []
    assert images == (sorted(p.name for p in (jax / "images").glob("*.png"))
                      if save_images else [])
    assert images == (["contour.image-iter00000000.png"] if save_images else [])
    assert (port / "images").exists() == save_images
    lines = [json.loads(line) for line in open(port / "metrics.jsonl")]
    assert lines == [json.loads(line) for line in open(jax / "metrics.jsonl")]


def test_file_logger_without_tensorboardx_warns(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    logger = FileLogger(str(tmp_path), use_tensorboard=True)
    with pytest.warns(UserWarning, match="tensorboardX"):
        logger.setup(FakeContext(__file__))
    logger.log({"loss": 1.0})
    logger.close()
    assert logger.tb_writer is None and not (logger.run_dir / "tb").exists()


def _stub_wandb(calls):
    """A wandb module that records what the logger asks of it."""
    wandb = types.ModuleType("wandb")

    class Run:
        def __init__(self, folder):
            self.dir = folder

    def init(**kwargs):
        calls.append(("init", {k: v for k, v in kwargs.items() if k not in ("dir", "settings")}))
        wandb.run = Run(kwargs["dir"])
        return wandb.run

    class Table:
        def __init__(self, columns=None, data=None, dataframe=None):
            if dataframe is not None:
                columns, data = list(dataframe.columns), dataframe.values.tolist()
            self.content = (list(columns), [list(row) for row in data])

        def __eq__(self, other):
            return self.content == other.content

    class WandbImage:
        def __init__(self, image):
            self.size = image.size

        def __eq__(self, other):
            return self.size == other.size

    wandb.init = init
    wandb.Table, wandb.Image = Table, WandbImage
    wandb.Settings = lambda **kwargs: kwargs
    wandb.util = types.SimpleNamespace(generate_id=lambda: "run123")
    wandb.define_metric = lambda *args, **kwargs: calls.append(("define_metric", args, kwargs))
    wandb.save = lambda path, base_path, policy: calls.append(
        ("save", path.rsplit("/", 1)[-1], base_path.split("/")[-3:], policy))
    wandb.log = lambda payload: calls.append(("log", payload))
    wandb.finish = lambda: calls.append(("finish",))
    return wandb


def test_wandb_logger_matches_jax_against_a_stub(tmp_path, monkeypatch):
    import pandas as pd

    columns = {"subject": ["a", "b"], "dice": [0.5, 0.75]}
    runs = {}
    for name, cls, table in (("jax", JWandbLogger, pd.DataFrame(columns)),
                             ("port", WandbLogger, Table(columns))):
        calls = []
        monkeypatch.setitem(sys.modules, "wandb", _stub_wandb(calls))
        logger = cls("project", group="group", logs_dir=str(tmp_path / name))
        context = FakeContext(__file__)
        logger.setup(context)
        for record in _records():
            logger.log(dict(record, table=table))
        logger.save_context(context, "checkpoints", 3)
        logger.close()
        runs[name] = calls, context
    (jcalls, jcontext), (tcalls, tcontext) = runs["jax"], runs["port"]
    assert tcalls == jcalls
    assert tcontext.name == jcontext.name and tcontext.name.endswith("-run123")
    assert tcontext.metadata == jcontext.metadata == {"wandb_run_id": "run123"}
    assert [c[1] for c in tcalls if c[0] == "save"] == [
        "test_torch_loggers.py", f"{tcontext.name}-iter00000003.ckpt"]


def test_wandb_logger_without_wandb_names_file_logger(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(ImportError, match="FileLogger"):
        WandbLogger("project")
