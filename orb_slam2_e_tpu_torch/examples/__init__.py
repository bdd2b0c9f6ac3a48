"""Example programs of the PyTorch port, one per example under the
repository's `examples/`, run as modules:

    python3 -m orb_slam2_e_tpu_torch.examples.rgbd_tum settings.yaml seq assoc.txt

Each takes its counterpart's arguments, prints its lines and writes its
files, and adds `--device` (default `cuda`; without a card torch's own
error ends the run, nothing falls back to the CPU) and `--seed` (the RANSAC
draws). `main(argv=None)` of each can be called from Python and returns the
system it drove.
"""
