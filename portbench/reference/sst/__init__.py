"""Frozen copies of the port's host modules and of its kernels' plain
PyTorch versions, for the benchmark's reference.

Each module is a copy of a ``soundswallower_tpu_torch`` module as it
stood when the benchmark was written (``config``, ``logmath``,
``mdef``, ``dictionary``, ``dict2pid``, ``s3file``, ``am``,
``fe/warp``, ``fe/frontend`` as ``frontend``, ``fe/feat`` as ``feat``,
``ops/align_graph`` as ``align_graph``, ``ops/senscore_torch`` as
``senscore``, ``ops/align_torch`` as ``viterbi``), with every function
that launches a kernel taken out and the callers that dispatched to one
calling the plain version, and the code the reference does not reach
removed.  Their module docstrings are the port's: they name the kernels
whose plain versions these are, and some functions left out here.
Nothing here imports the port, the JAX package or JAX, so later changes
to the program do not move the reference.
"""
