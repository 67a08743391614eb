"""The benchmark of the PyTorch and CUDA port (``openhyperflow2d_torch``).

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the repository's root, on a machine with a CUDA card.
Everything a cell needs is data found by name: ``workloads/<cell>.json``
names a configuration (``configs/<config>/``: the deck as text and
``config.json``) and a traffic file (``traffic/<traffic>.json``); each
metric of ``BENCHMARK.json`` is read by ``metrics/<metric>.py``; the work
an iteration needs is counted per class of node by ``work/<class>.py``.
``reference/`` is the plain reference that decides ``correct``; it imports
nothing of the port.
"""
