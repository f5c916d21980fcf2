import os
import tempfile

try:
    from hypothesis import configuration as _hypothesis_configuration
except ImportError:
    _hypothesis_configuration = None

# Hypothesis keeps its example database and its unicode caches in one
# directory, ``.hypothesis/`` of the working directory by default, and
# rewrites a cache there on every run.  Keep it outside the checkout, at
# a fixed path so the example database survives between runs.
if _hypothesis_configuration is not None:
    _hypothesis_configuration.set_hypothesis_home_dir(
        os.path.join(tempfile.gettempdir(), "zerrow-hypothesis"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one (run on the "
        "card with `python -m pytest -q -m gpu tests/test_torch_gpu.py`)")
