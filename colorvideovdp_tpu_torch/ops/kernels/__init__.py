"""Hand-written CUDA kernels and their wrappers. Each wrapper counts its own
launches in ``<wrapper>.launches``."""


def counted_wrappers() -> dict:
    """Every kernel wrapper by name, each with its ``launches`` counter."""
    from . import (band_fused, band_pooled, blur, csf_lut, ingest, interleave, masking_fused,
                   pyramid_reduce)

    mf = masking_fused
    return {"ingest": ingest.ingest, "ingest_replicate": ingest.ingest_replicate,
            "ingest_head": ingest.ingest_head,
            "pyramid_reduce": pyramid_reduce.pyramid_reduce,
            "pyramid_reduce_slab": pyramid_reduce.pyramid_reduce_slab,
            "band_pooled": band_pooled.band_pooled, "band_pooled_d": band_pooled.band_pooled_d,
            "band_pooled_halo": band_pooled.band_pooled_halo,
            "band_pooled_d_halo": band_pooled.band_pooled_d_halo,
            "band_masking": mf.band_masking, "band_masking_halo": mf.band_masking_halo,
            "band_masking_d": mf.band_masking_d, "band_masking_d_noblur": mf.band_masking_d_noblur,
            "band_masking_contrast": mf.band_masking_contrast,
            "band_masking_contrast_d": mf.band_masking_contrast_d,
            "band_fused": band_fused.band_fused, "band_fused_d": band_fused.band_fused_d,
            "csf_lut": csf_lut.csf_lut, "csf_lut_bwd": csf_lut.csf_lut_bwd, "blur": blur.blur,
            "blur_adjoint": blur.blur_adjoint,
            "interleave": interleave.interleave, "concat": interleave.concat,
            "deinterleave": interleave.deinterleave}
