"""Typed pipeline configuration (counterpart of ``tobac_flow_tpu/config.py``).

One dataclass carries every tunable of a production run: the optical flow,
core and anvil detection, linking, validation, ingest and output choices.
It reads and writes the same JSON as the reference's ``PipelineConfig``
(keys it does not know are ignored) and builds the port's
``DetectionOptions`` for ``cli.common.run_detection``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

__all__ = ["PipelineConfig"]


@dataclasses.dataclass
class PipelineConfig:
    # optical flow
    flow_model: str = "Farneback"
    vr_steps: int = 1
    smoothing_passes: int = 1
    interp_method: str = "cubic"
    flow_max_value: float = 20.0

    # core detection
    wvd_threshold: float = 0.25
    bt_threshold: float = 0.5
    overlap: float = 0.5
    absolute_overlap: int = 4
    subsegment_shrink: float = 0.0
    t_offset: int = 3
    use_wvd: bool = False

    # anvil detection
    thick_upper: float = -5.0
    thick_lower: float = -12.5
    thin_upper: float = 0.0
    thin_lower: float = -7.5
    erode_distance: int = 2
    relabel_anvils: bool = True

    # linking
    link_atol: int = 5
    link_rtol: float = 0.5

    # validation
    validation_margin: int = 10
    validation_time_margin: int = 3

    # ingest
    n_pad_files: int = 12
    time_gap_minutes: float = 15.0

    # outputs
    save_label_props: bool = True
    save_field_props: bool = True
    save_spatial_props: bool = False

    def to_json(self, path):
        Path(path).write_text(json.dumps(dataclasses.asdict(self), indent=2))

    @classmethod
    def from_json(cls, path):
        data = json.loads(Path(path).read_text())
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})

    def detection_options(self):
        """The port's ``DetectionOptions`` with this configuration's
        thresholds, flow settings and output choices."""
        from tobac_flow_tpu_torch.detect.chain import DetectionOptions

        return DetectionOptions(
            wvd_threshold=self.wvd_threshold,
            bt_threshold=self.bt_threshold,
            overlap=self.overlap,
            absolute_overlap=self.absolute_overlap,
            subsegment_shrink=self.subsegment_shrink,
            t_offset=self.t_offset,
            use_wvd=self.use_wvd,
            thick_upper=self.thick_upper,
            thick_lower=self.thick_lower,
            thin_upper=self.thin_upper,
            thin_lower=self.thin_lower,
            erode_distance=self.erode_distance,
            relabel=self.relabel_anvils,
            flow_model=self.flow_model,
            vr_steps=self.vr_steps,
            smoothing_passes=self.smoothing_passes,
            interp_method=self.interp_method,
            save_label_props=self.save_label_props,
            save_field_props=self.save_field_props,
            save_spatial_props=self.save_spatial_props,
        )
