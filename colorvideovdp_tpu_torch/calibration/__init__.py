"""Calibration of the PyTorch port (counterpart of the top-level
``calibration/`` of the JAX package): ``extract_features`` scores every rated
pair of a dataset once with the full metric on the card and caches its
per-band features; ``train`` re-fits the pooling parameters to the ratings
over those features with Adam; ``data.VideoDataset`` reads the features.

    python -m colorvideovdp_tpu_torch.calibration.extract_features dataset.csv -d standard_fhd
    python -m colorvideovdp_tpu_torch.calibration.train dataset.csv -e 50 --save best-rmse

Both run on the card (``--device cuda``, the default) unless ``--device cpu``
is given, and fail without a card rather than move to the CPU."""
