"""The port's copies of the JAX package's host helpers against the originals:
utils/misc.py (sequence helpers, folds, time strings), utils/compact_json.py,
utils/config.py, and utils/timer.py's Timer."""
import numpy as np
import pytest
import torch

from segmentation_pipeline_tpu.utils import compact_json as jjson
from segmentation_pipeline_tpu.utils import config as jconfig
from segmentation_pipeline_tpu.utils import misc as jmisc
from segmentation_pipeline_torch.utils import compact_json as tjson
from segmentation_pipeline_torch.utils import config as tconfig
from segmentation_pipeline_torch.utils import misc as tmisc
from segmentation_pipeline_torch.utils.timer import Timer


@pytest.mark.parametrize("name, args", [
    ("is_sequence", ([1],)), ("is_sequence", ((1,),)), ("is_sequence", ("ab",)),
    ("as_list", ((1, 2),)), ("as_list", (3,)),
    ("as_set", ([1, 1, 2],)), ("as_set", (range(3),)), ("as_set", ("ab",)),
    ("vargs_or_sequence", (([1, 2],),)), ("vargs_or_sequence", ((1, 2),)),
    ("random_folds", (11, 4, 0xDEADBEEF)), ("random_folds", (5, 5, 0)),
    ("time_str_to_seconds", ("1-02:03:04",)), ("time_str_to_seconds", ("05:06",)),
    ("time_str_to_seconds", (90,)), ("time_str_to_seconds", ("7",)),
])
def test_misc_helpers_match_jax(name, args):
    assert getattr(tmisc, name)(*args) == getattr(jmisc, name)(*args)


class Leaf(tconfig.Config):
    def __init__(self, a, b=(1, 2)):
        self.a, self.b = a, b


def test_compact_json_and_configs_match_jax():
    value = {"ints": list(range(5)), "nested": {"arr": np.arange(3.0), "x": np.float32(0.5)},
             "long": list(range(60)), "rows": [{"a": 1}, (2, "b")], "empty": {}}
    for indent, width in ((2, 100), (4, 20)):
        assert tjson.CompactJSONEncoder(indent, width).encode(value) == \
            jjson.CompactJSONEncoder(indent, width).encode(value)
    obj = Leaf(a={"k": [Leaf(3)]})
    assert tconfig.get_nested_config(obj) == jconfig.get_nested_config(obj)
    assert obj.get_config() == {"__class__": "Leaf", "a": {"k": [{"__class__": "Leaf", "a": 3,
                                                                   "b": [1, 2]}]}, "b": [1, 2]}


def test_timer_sums_named_splits():
    timer = Timer()
    timer.start()
    timer.stamp("a", sync_on=torch.zeros(1))
    timer.stamp("b")
    timer.stamp("a")
    assert list(timer.timestamps) == ["a", "b"]
    assert all(v >= 0 for v in timer.timestamps.values())
