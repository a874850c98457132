"""SMOF core: streaming memory optimisation with smart off-chip eviction.

The paper's contribution (§III-IV) as a hardware-agnostic library: a layer
graph IR, the activation-eviction / weight-fragmentation / subgraph-
reconfiguration mechanisms with their cost models, the refined pipeline-depth
estimator, and the greedy iterative DSE (Algorithm 1).  Pure Python: the
PyTorch port keeps its own copy so that it searches exactly the plans the
reference package does without importing it.
"""
from .graph import Edge, Graph, Vertex, WEIGHTY
from .resources import (ALL_DEVICES, Device, get_device, U200, VCU118,
                        VCU1525, ZCU102)
from .pipeline import (initiation_interval, initiation_rate, interval_prev,
                       pipeline_depth, vertex_delays)
from .eviction import (apply_eviction, candidate_evictions, evaluate_eviction,
                       EvictionOption)
from .fragmentation import (apply_fragmentation, candidate_fragmentations,
                            evaluate_fragmentation, FragmentationOption)
from .partition import (fits, initial_partition, latency_s, merge,
                        Partitioning, subgraph_cost, throughput_fps)
from .dse import DSEConfig, DSEResult, pack_onchip, run_dse
from .plan import (ExecutionPlan, hand_cut_plan, LayerPlan, plan_from_dse,
                   StreamPlan)
from .builders import (build_unet, build_unet3d, build_unet_exec,
                       build_x3d_exec, build_x3d_m, build_yolo_head_exec,
                       build_yolov8n, exec_input_shape, get_model,
                       EXEC_MODELS, PAPER_MODELS, TABLE3)

__all__ = [n for n in dir() if not n.startswith("_")]
