"""Hand-written CUDA kernels and their wrappers. Each wrapper counts its own
launches in ``<wrapper>.launches``."""


def counted_wrappers() -> dict:
    """Every kernel wrapper by name, each with its ``launches`` counter."""
    from . import band_pooled, blur, csf_lut, ingest, interleave, pyramid_reduce

    return {"ingest": ingest.ingest, "ingest_replicate": ingest.ingest_replicate,
            "ingest_head": ingest.ingest_head,
            "pyramid_reduce": pyramid_reduce.pyramid_reduce,
            "pyramid_reduce_slab": pyramid_reduce.pyramid_reduce_slab,
            "band_pooled": band_pooled.band_pooled, "band_pooled_d": band_pooled.band_pooled_d,
            "band_pooled_halo": band_pooled.band_pooled_halo,
            "band_pooled_d_halo": band_pooled.band_pooled_d_halo,
            "csf_lut": csf_lut.csf_lut, "csf_lut_bwd": csf_lut.csf_lut_bwd, "blur": blur.blur,
            "blur_adjoint": blur.blur_adjoint,
            "interleave": interleave.interleave, "concat": interleave.concat,
            "deinterleave": interleave.deinterleave}
