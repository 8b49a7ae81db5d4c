"""Performance models of the port (port of ``src/repro/perfmodel``): the
paper's CIM model over its Table II hardware (``hardware.py``, the first
half of ``model.py``; arithmetic on the paper's constants, measured on no
card) and the roofline the kernel-config tuner scores against (the second
half of ``model.py``)."""
from repro_torch.perfmodel.hardware import DEFAULT_HW, GPU, GpuAnchors, Hardware
from repro_torch.perfmodel.model import (BERT_BASE, BERT_LARGE, PLATFORMS, SMS,
                                         PlatformSpec, bert_ops,
                                         encoder_layer_energy_j,
                                         encoder_layer_latency_s,
                                         end_to_end_latency_s, end_to_end_tops,
                                         headline_numbers, mvm_stage_s,
                                         node_power_w, paged_kernel_roofline,
                                         paged_kernel_traffic, platform_spec,
                                         softmax_cores, softmax_energy_j,
                                         softmax_fraction, softmax_latency_s,
                                         tops_per_watt,
                                         varlen_attention_roofline,
                                         varlen_attention_traffic)

__all__ = ["Hardware", "GpuAnchors", "DEFAULT_HW", "GPU",
           "softmax_latency_s", "softmax_energy_j", "softmax_cores",
           "encoder_layer_latency_s", "encoder_layer_energy_j",
           "softmax_fraction", "end_to_end_tops", "end_to_end_latency_s",
           "tops_per_watt", "bert_ops", "headline_numbers",
           "BERT_BASE", "BERT_LARGE", "mvm_stage_s", "node_power_w",
           "PlatformSpec", "PLATFORMS", "SMS", "platform_spec",
           "varlen_attention_traffic", "varlen_attention_roofline",
           "paged_kernel_traffic", "paged_kernel_roofline"]
