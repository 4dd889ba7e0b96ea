"""Display photometry (EOTF -> absolute cd/m^2) and geometry (pixels-per-degree).

PyTorch counterpart of ``colorvideovdp_tpu/display.py``: the photometric
forward model (:190-238), the colour pipeline to every target colour space
(:89-147) and the viewing geometry (:261-448). Display parameters are Python
floats.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from .ops import colorspace as cs
from .ops.clip import clip
from .utils.config import config_files, json2dict


class vvdp_display_photometry:
    """Base class: knows the source colour space and its RGB->XYZ matrix."""

    def __init__(self, source_colorspace="sRGB", config_paths=None):
        colorspaces_file = config_files.find("color_spaces.json", config_paths or [])
        colorspaces = json2dict(colorspaces_file)
        if source_colorspace not in colorspaces:
            raise RuntimeError(
                f'Color space: "{source_colorspace}" not found in "{colorspaces_file}"'
            )
        spec = colorspaces[source_colorspace]
        if "RGB2X" in spec:  # 'luminance' has no primaries
            self.rgb2xyz = np.array(
                [spec["RGB2X"], spec["RGB2Y"], spec["RGB2Z"]], dtype=np.float32
            )
        self.EOTF = spec["EOTF"]

    def forward(self, V):
        raise NotImplementedError

    def print(self):
        raise NotImplementedError

    @classmethod
    def list_displays(cls, config_paths=None):
        """Log every display model of display_models.json (the CLI's
        ``--display ?``)."""
        models_file = config_files.find("display_models.json", config_paths or [])
        logging.info(f"JSON file with display models: {models_file}")
        for display_name in json2dict(models_file):
            cls.load(display_name, config_paths).print()

    @classmethod
    def load(cls, display_name, config_paths=None):
        """Build a photometric model from display_models.json."""
        config_paths = config_paths or []
        models_file = config_files.find("display_models.json", config_paths)
        models = json2dict(models_file)
        if display_name not in models:
            logging.error(f"Display model: '{display_name}' not found in '{models_file}'")
            raise RuntimeError("Display model not found")
        model = models[display_name]

        Y_peak = model["max_luminance"]
        if "min_luminance" in model:
            contrast = Y_peak / model["min_luminance"]
        else:
            contrast = model.get("contrast", 500)

        obj = vvdp_display_photo_eotf(
            Y_peak,
            contrast=contrast,
            source_colorspace=model.get("colorspace", "sRGB"),
            E_ambient=model.get("E_ambient", 0),
            k_refl=model.get("k_refl", 0.005),
            exposure=model.get("exposure", 1),
            name=display_name,
            config_paths=config_paths,
        )
        obj.full_name = model["name"]
        obj.short_name = display_name
        return obj

    def source_2_target_colorspace(self, I_src: torch.Tensor, target_colorspace):
        """Source (display-encoded or linear) frame (BCFHW) -> the target colour
        space: a metric space, a linear space of ``linear_2_target_colorspace``,
        or a display-encoded 0..1 space for the aux metrics (HDR and linear
        content PU21-encoded and divided by the code of 10000 cd/m^2, of 100
        cd/m^2 or of the display's peak)."""
        if target_colorspace in ("display_encoded_01", "display_encoded_dmax",
                                 "display_encoded_100nit"):
            if self.is_input_display_encoded() and not (
                    isinstance(self, vvdp_display_photo_eotf) and self.EOTF == "PQ"):
                return I_src.to(torch.float32)
            if not hasattr(self, "PU"):
                self.PU = cs.PU()
            if target_colorspace == "display_encoded_01":
                PU_max = self.PU.encode(10000.0)
            elif target_colorspace == "display_encoded_100nit":
                PU_max = self.PU.encode(100.0)
            else:
                PU_max = self.PU.encode(self.get_peak_luminance())
            return self.PU.encode(self.forward(I_src)) / float(PU_max)

        I_lin = self.forward(I_src)
        if I_src.shape[-4] == 3:
            return self.linear_2_target_colorspace(I_lin, target_colorspace)
        # Luminance-only content bypasses the colour transform.
        return I_lin

    def linear_2_target_colorspace(self, RGB_lin: torch.Tensor, target_colorspace):
        """Display-native linear RGB -> the target space via one fused 3x3
        matrix: Y, XYZ, LMS2006, DKLd65, RGB709, RGB2020, RGB2020pq (then PQ
        encoded) or logLMS_DKLd65 (LMS2006, log10 (``cs.log10_rn``), then
        LMS -> DKL)."""
        rgb2xyz = np.asarray(self.rgb2xyz, np.float32)
        if target_colorspace == "Y":
            w = torch.as_tensor(rgb2xyz[1], dtype=RGB_lin.dtype, device=RGB_lin.device)
            return torch.sum(RGB_lin * w.reshape(3, 1, 1, 1), dim=-4, keepdim=True)
        if target_colorspace == "DKLd65":
            return cs.apply_color_matrix(RGB_lin, self.rgb2dkl())
        if target_colorspace == "logLMS_DKLd65":
            LMS = cs.apply_color_matrix(RGB_lin, self.rgb2lms())
            return cs.lms2006_to_dkld65(cs.log10_rn(LMS))
        if target_colorspace == "XYZ":
            rgb2abc = rgb2xyz
        elif target_colorspace == "LMS2006":
            rgb2abc = self.rgb2lms()
        elif target_colorspace == "RGB709":
            rgb2abc = cs.XYZ_to_RGB709 @ rgb2xyz
        elif target_colorspace in ("RGB2020", "RGB2020pq"):
            rgb2abc = cs.XYZ_to_RGB2020 @ rgb2xyz
        else:
            raise RuntimeError(f"Unknown colorspace '{target_colorspace}'")
        ABC = cs.apply_color_matrix(RGB_lin, rgb2abc)
        if target_colorspace == "RGB2020pq":
            ABC = cs.lin2pq(ABC)
        return ABC

    def rgb2dkl(self) -> np.ndarray:
        """The fused RGB -> DKLd65 3x3 of the display's primaries."""
        return (cs.LMS2006_to_DKLd65 @ cs.XYZ_to_LMS2006
                @ np.asarray(self.rgb2xyz, np.float32)).astype(np.float32)

    def rgb2lms(self) -> np.ndarray:
        """The RGB -> LMS2006 3x3 of the display's primaries."""
        return (cs.XYZ_to_LMS2006 @ np.asarray(self.rgb2xyz, np.float32)).astype(np.float32)


class vvdp_display_photo_eotf(vvdp_display_photometry):
    """GOG-style display model with sRGB / PQ / HLG / linear / gamma EOTFs."""

    def __init__(self, Y_peak, contrast=1000, source_colorspace="sRGB", EOTF=None,
                 E_ambient=0, k_refl=0.005, exposure=1, name=None,
                 config_paths=None):
        super().__init__(source_colorspace=source_colorspace, config_paths=config_paths)
        if EOTF is not None:
            self.EOTF = EOTF
        self.Y_peak = Y_peak
        self.contrast = contrast
        self.E_ambient = E_ambient
        self.k_refl = k_refl
        self.name = name
        self.exposure = exposure

    def is_input_display_encoded(self):
        return self.EOTF != "linear"

    def hlg_gamma(self):
        """System gamma of the HLG OOTF (BBC WHP 369 extension above 1000 nit)."""
        if self.Y_peak > 1000:
            return (1.2 + 0.42 * math.log10(self.Y_peak / 1000)
                    - 0.07623 * math.log10(self.E_ambient / 5))
        return 1.2

    def hlg_from_s(self, rgb_s: torch.Tensor) -> torch.Tensor:
        """An HLG display's luminance from the per-channel inverse OETF
        ``cs.hlg_s`` (colour axis at -4): the OOTF, exposure and the GOG."""
        Y_black, Y_refl = self.get_black_level()
        lin = cs.hlg_ootf(rgb_s, self.hlg_gamma())
        if self.exposure != 1:
            lin = clip(lin * self.exposure, 0.0, 1.0)
        return (self.Y_peak - Y_black) * lin + Y_black + Y_refl

    def forward(self, V: torch.Tensor) -> torch.Tensor:
        """Display-encoded (or linear) values -> absolute cd/m^2 emitted."""
        V = V.to(torch.float32)
        Y_black, Y_refl = self.get_black_level()

        if self.EOTF == "sRGB":
            lin = cs.srgb2lin(clip(V, 0.0, 1.0))
            if self.exposure != 1:
                lin = clip(lin * self.exposure, 0.0, 1.0)
            return (self.Y_peak - Y_black) * lin + Y_black + Y_refl
        if self.EOTF == "PQ":
            V = clip(V, 0.0, 1.0)
            return (clip(cs.pq2lin(V) * self.exposure, 0.005, self.Y_peak)
                    + Y_black + Y_refl)
        if self.EOTF == "linear":
            return clip(V * self.exposure, max(0.005, Y_black), self.Y_peak) + Y_refl
        if self.EOTF == "HLG":
            return self.hlg_from_s(cs.hlg_s(clip(V, 0.0, 1.0)))
        if self.EOTF[0].isnumeric():
            V = clip(V, 0.0, 1.0)
            lin = clip(torch.pow(V, float(self.EOTF)) * self.exposure, 0.0, 1.0)
            return (self.Y_peak - Y_black) * lin + Y_black + Y_refl
        raise RuntimeError(f"Unknown EOTF '{self.EOTF}'")

    def get_peak_luminance(self):
        return self.Y_peak

    def get_black_level(self):
        Y_refl = self.E_ambient / math.pi * self.k_refl
        Y_black = self.Y_peak / self.contrast
        return Y_black, Y_refl

    def print(self):
        Y_black, Y_refl = self.get_black_level()
        logging.info(f"Photometric display model: {self.name}")
        logging.info(f"  Peak luminance: {self.Y_peak} cd/m^2")
        logging.info(f"  EOTF: {self.EOTF}")
        logging.info(f"  Contrast - theoretical: {round(self.contrast)}:1")
        logging.info(f"  Contrast - effective: {round(self.Y_peak / (Y_black + Y_refl))}:1")
        logging.info(f"  Ambient light: {self.E_ambient} lux")
        logging.info(f"  Display reflectivity: {self.k_refl * 100}%")


class vvdp_display_geometry:
    """Viewing geometry -> pixels-per-degree."""

    def __init__(self, resolution, distance_m=None, distance_display_heights=None,
                 fov_horizontal=None, fov_vertical=None, fov_diagonal=None,
                 diagonal_size_inches=None, ppd=None):
        self.resolution = resolution
        ar = resolution[0] / resolution[1]

        if ppd is not None:
            self.fixed_ppd = ppd
            return
        self.fixed_ppd = None

        if diagonal_size_inches is not None:
            height_mm = math.sqrt((diagonal_size_inches * 25.4) ** 2 / (1 + ar**2))
            self.display_size_m = (ar * height_mm / 1000, height_mm / 1000)

        if distance_m is not None and distance_display_heights is not None:
            raise RuntimeError(
                "You can pass only one of: 'distance_m', 'distance_display_heights'.")
        if distance_m is not None:
            self.distance_m = distance_m
        elif distance_display_heights is not None:
            if not hasattr(self, "display_size_m"):
                raise RuntimeError(
                    "You need to specify display diagonal size 'diagonal_size_inches' "
                    "to specify viewing distance as 'distance_display_heights'")
            self.distance_m = distance_display_heights * self.display_size_m[1]
        elif fov_horizontal is not None or fov_vertical is not None or fov_diagonal is not None:
            self.distance_m = 3  # default viewing distance for HMDs
        else:
            raise RuntimeError(
                "Viewing distance must be specified as 'distance_m' or "
                "'distance_display_heights'.")

        if sum(x is not None for x in (fov_horizontal, fov_vertical, fov_diagonal)) > 1:
            raise RuntimeError(
                "You can pass only one of 'fov_horizontal', 'fov_vertical', 'fov_diagonal'.")
        if fov_horizontal is not None:
            width_m = 2 * math.tan(math.radians(fov_horizontal / 2)) * self.distance_m
            self.display_size_m = (width_m, width_m / ar)
        elif fov_vertical is not None:
            height_m = 2 * math.tan(math.radians(fov_vertical / 2)) * self.distance_m
            self.display_size_m = (height_m * ar, height_m)
        elif fov_diagonal is not None:
            distance_px = math.sqrt(resolution[0] ** 2 + resolution[1] ** 2) / (
                2.0 * math.tan(math.radians(fov_diagonal * 0.5)))
            height_deg = math.degrees(math.atan(resolution[1] / 2 / distance_px)) * 2
            height_m = 2 * math.tan(math.radians(height_deg / 2)) * self.distance_m
            self.display_size_m = (height_m * ar, height_m)

    def get_ppd(self, eccentricity=None):
        """Pixels per degree at the centre, or (a float32 tensor) at each
        ``eccentricity`` in degrees."""
        if self.fixed_ppd is not None:
            return self.fixed_ppd
        pix_deg = 2 * math.degrees(
            math.atan(0.5 * self.display_size_m[0] / self.resolution[0] / self.distance_m))
        base_ppd = 1 / pix_deg
        if eccentricity is None:
            return base_ppd
        # tan(a + delta) - tan(a) cancels: float32 tangents one ulp apart
        # move the result by up to 1e-3, so it is taken in float64 (from the
        # float32 eccentricity) and rounded once.
        delta = pix_deg / 2
        tan_delta = math.tan(math.radians(delta))
        ecc = torch.as_tensor(eccentricity, dtype=torch.float32).to(torch.float64)
        tan_a = torch.tan(torch.deg2rad(ecc))
        return (base_ppd * (torch.tan(torch.deg2rad(ecc + delta)) - tan_a)
                / tan_delta).to(torch.float32)

    def pix2eccentricity(self, resolution_pix, x_pix, y_pix, gaze_pix):
        """Eccentricity in degrees (float32) of the pixels (x_pix, y_pix) from
        the gaze point ``gaze_pix``, all in pixels of a ``resolution_pix``
        image."""
        x_pix, y_pix = (torch.as_tensor(v, dtype=torch.float32) for v in (x_pix, y_pix))
        if self.fixed_ppd is not None:
            return torch.sqrt((x_pix - float(gaze_pix[0])) ** 2
                              + (y_pix - float(gaze_pix[1])) ** 2) / self.fixed_ppd
        shift_to_centre = -np.asarray(resolution_pix) / 2
        x_m = ((x_pix + float(shift_to_centre[0])) * self.display_size_m[0]
               / self.resolution[0])
        y_m = ((y_pix + float(shift_to_centre[1])) * self.display_size_m[1]
               / self.resolution[1])
        gaze_m = ((np.asarray(gaze_pix) + shift_to_centre) * np.asarray(self.display_size_m)
                  / np.asarray(self.resolution))
        gaze_deg = np.degrees(np.arctan(gaze_m / self.distance_m))
        return torch.sqrt(
            (torch.rad2deg(torch.arctan(x_m / self.distance_m)) - float(gaze_deg[0])) ** 2
            + (torch.rad2deg(torch.arctan(y_m / self.distance_m)) - float(gaze_deg[1])) ** 2)

    def get_resolution_magnification(self, eccentricity):
        """How much larger a pixel looks at ``eccentricity`` (degrees) than at
        the centre."""
        if self.fixed_ppd is not None:
            return torch.ones_like(torch.as_tensor(eccentricity, dtype=torch.float32))
        # Taken in float64 and rounded once, as ``get_ppd``.
        ecc = torch.clamp(torch.as_tensor(eccentricity, dtype=torch.float32), max=89.9)
        pix_rad = 2 * math.atan(0.5 * self.display_size_m[0] / self.resolution[0]
                                / self.distance_m)
        delta = pix_rad / 2
        tan_delta = math.tan(delta)
        tan_a = torch.tan(torch.deg2rad(ecc.to(torch.float64)))
        return ((torch.tan(torch.deg2rad(ecc.to(torch.float64)) + delta) - tan_a)
                / tan_delta).to(torch.float32)

    @classmethod
    def load(cls, display_name, config_paths=None):
        config_paths = config_paths or []
        models_file = config_files.find("display_models.json", config_paths)
        models = json2dict(models_file)
        if display_name not in models:
            logging.error(f"Display model: '{display_name}' not found in '{models_file}'")
            raise RuntimeError("Display model not found")
        model = models[display_name]
        if "resolution" not in model:
            raise RuntimeError(f"Display model '{display_name}' has no resolution")
        inches_to_meters = 0.0254
        W, H = model["resolution"]
        if "pixels_per_degree" in model:
            return cls((W, H), ppd=model["pixels_per_degree"])

        if "viewing_distance_meters" in model:
            distance_m = model["viewing_distance_meters"]
        elif "viewing_distance_inches" in model:
            distance_m = model["viewing_distance_inches"] * inches_to_meters
        else:
            distance_m = None
        if "diagonal_size_meters" in model:
            diag_size_inch = model["diagonal_size_meters"] / inches_to_meters
        elif "diagonal_size_inches" in model:
            diag_size_inch = model["diagonal_size_inches"]
        else:
            diag_size_inch = None
        return cls((W, H), distance_m=distance_m, fov_diagonal=model.get("fov_diagonal"),
                   diagonal_size_inches=diag_size_inch)
