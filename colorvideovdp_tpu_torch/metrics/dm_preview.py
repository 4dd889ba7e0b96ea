"""Display-model preview "metrics" (counterpart of
``colorvideovdp_tpu/metrics/dm_preview.py``): write the display model's
output as EXR frames or PQ video for visual inspection. The display model
runs on the metric's device through the per-frame API; each frame is copied
to the host once and written there."""

from __future__ import annotations

import numpy as np

from ..io.writers import VideoWriter
from .base import metric_device, register_metric, vq_metric


def _frame_to_hwc(T):
    """(B, C, 1, H, W) tensor -> (H, W, C) host array of the first batch item."""
    return T[0, :, 0].permute(1, 2, 0).cpu().numpy()


class dm_preview(vq_metric):
    """Writes test/reference frames after the display model: EXR (images or
    the ``_exr`` variants, linear BT.709 RGB) or PQ-encoded BT.2020 video."""

    def __init__(self, output_exr=False, side_by_side=False, display_name="standard_4k",
                 display_photometry=None, device="cuda", verbose=False, config_paths=None):
        self.output_exr = output_exr
        self.side_by_side = side_by_side
        self.set_display_model(display_name=display_name, display_photometry=display_photometry,
                               config_paths=config_paths)
        self.device = metric_device(device)
        self.verbose = verbose

    def predict_video_source(self, vid_source):
        _, _, N_frames = vid_source.get_video_size()
        assert vid_source.get_batch_size() == 1, "DM-preview does not work with batches"
        write_exr = self.output_exr or N_frames == 1
        base = getattr(self, "base_fname", "dm_preview")

        if write_exr:
            colorspace = "RGB709"
        else:
            colorspace = "RGB2020pq"
            fps = vid_source.get_frames_per_second()
            test_vw = VideoWriter(base + "-test.mp4", hdr_mode=True, fps=fps, codec="h265",
                                  verbose=self.verbose)
            if not self.side_by_side:
                ref_vw = VideoWriter(base + "-reference.mp4", hdr_mode=True, fps=fps,
                                     codec="h265", verbose=self.verbose)

        for ff in range(N_frames):
            T = _frame_to_hwc(vid_source.get_test_frame(ff, device=self.device,
                                                        colorspace=colorspace))
            R = _frame_to_hwc(vid_source.get_reference_frame(ff, device=self.device,
                                                             colorspace=colorspace))
            if self.side_by_side:
                concat_dim = 1 if T.shape[1] < T.shape[0] else 0
                T = np.concatenate((T, R), axis=concat_dim)
            frame_no = f"-{ff:04d}" if N_frames > 1 else ""
            if write_exr:
                from ..utils import exr

                exr.write(base + frame_no + "-test.exr", T)
                if not self.side_by_side:
                    exr.write(base + frame_no + "-reference.exr", R)
            else:
                test_vw.write_frame_rgb(T)
                if not self.side_by_side:
                    ref_vw.write_frame_rgb(R)

        if not write_exr:
            test_vw.close()
            if not self.side_by_side:
                ref_vw.close()
        return np.float32(-1), None

    def short_name(self):
        return "dm-preview"

    def quality_unit(self):
        return ""


class dm_preview_exr(dm_preview):
    def __init__(self, **kwargs):
        super().__init__(output_exr=True, **kwargs)


class dm_preview_sbs(dm_preview):
    def __init__(self, **kwargs):
        super().__init__(side_by_side=True, **kwargs)


class dm_preview_exr_sbs(dm_preview):
    def __init__(self, **kwargs):
        super().__init__(side_by_side=True, output_exr=True, **kwargs)


register_metric(dm_preview)
register_metric(dm_preview_sbs)
register_metric(dm_preview_exr)
register_metric(dm_preview_exr_sbs)
