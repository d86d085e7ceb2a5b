"""The port's copies of the reference's ``examples/`` scripts, each a
module with ``main(argv)`` that runs on the card unless ``--device cpu``
is given:

    python -m repro_torch.examples.quickstart
    python -m repro_torch.examples.serve_batched --arch yi-6b --requests 6
    python -m repro_torch.examples.train_tiny --steps 200
    python -m repro_torch.examples.tune_operator --size 384 --configs 16

Importing one does no work.
"""
