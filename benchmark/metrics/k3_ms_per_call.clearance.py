"""Device ms of K3's kernels (`csrc/clearance.cu`: plan, task, finish and
the representatives' nocull scan) per `min_distances` call, from the
traced slice."""
from harness.readers import K3, kernel_ms_per_call


def read(record):
    return kernel_ms_per_call(record, K3)
