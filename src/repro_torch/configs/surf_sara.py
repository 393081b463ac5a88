"""SURF-SARA datacenter topology (paper §3.2) for the digital twin."""

from repro_torch.traces.schema import DatacenterConfig


def config() -> DatacenterConfig:
    return DatacenterConfig(
        num_hosts=277,
        cores_per_host=16,
        ghz=2.1,
        mem_gb=128.0,
    )
