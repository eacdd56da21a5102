"""The port's ``PipelineConfig`` against ``tobac_flow_tpu/config.py``.

Tolerance: exact.  A JSON written by either class is read by the other
into equal fields (unknown keys ignored), and ``detection_options()``
carries every field the reference's carries, with the same values, into
the port's ``DetectionOptions``.
"""

import dataclasses
import json

import pytest

pytest.importorskip("jax")

from tobac_flow_tpu.config import PipelineConfig as JaxConfig  # noqa: E402
from tobac_flow_tpu_torch.config import PipelineConfig  # noqa: E402
from tobac_flow_tpu_torch.detect.chain import DetectionOptions  # noqa: E402

CHANGED = {"flow_model": "DIS", "interp_method": "lanczos", "subsegment_shrink": 0.1,
           "vr_steps": 2, "thick_upper": -4.0, "relabel_anvils": False, "link_rtol": 0.25,
           "save_spatial_props": True}


def test_fields_and_defaults_match():
    assert ([(f.name, f.default) for f in dataclasses.fields(PipelineConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(JaxConfig)])


@pytest.mark.parametrize("writer, reader", [(JaxConfig, PipelineConfig),
                                            (PipelineConfig, JaxConfig)])
def test_json_round_trip_across_packages(tmp_path, writer, reader):
    path = tmp_path / "config.json"
    writer(**CHANGED).to_json(path)
    got = reader.from_json(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(writer(**CHANGED))


def test_from_json_ignores_unknown_keys(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(json.dumps({**CHANGED, "not_a_field": 1}))
    assert PipelineConfig.from_json(path) == PipelineConfig(**CHANGED)


@pytest.mark.parametrize("changed", [{}, CHANGED])
def test_detection_options_field_by_field(changed):
    want = vars(JaxConfig(**changed).detection_options())
    got = PipelineConfig(**changed).detection_options()
    assert isinstance(got, DetectionOptions)
    got = vars(got)
    assert set(want) == set(got)
    for key, value in want.items():
        assert got[key] == value, key
