"""Model writers, each a module found by a configuration file's
``writer.kind`` (``writers/<kind>.py``), providing ``write(outdir,
config, seed)``: the model's files in ``outdir``, its weights drawn
from ``seed``."""
