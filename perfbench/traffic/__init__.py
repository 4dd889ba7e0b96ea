"""Traffic: one generator module per kind (``<kind>.py``, a ``Traffic``
class) and one data file per mix (``<mix>.json``, the parameters its kind
reads)."""
