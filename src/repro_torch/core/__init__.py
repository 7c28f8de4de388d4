"""FusionLLM core: OP-DAG IR, RAD, estimator, unified edge-cost model,
OP-Fence scheduler + joint co-planner, AdaTopK, and the decentralized
runtime."""
from .opgraph import (OpData, OpGraph, OpNode, OpProfile, OpType, SubDag,
                      build_subdags)
from .estimator import (ClusterSpec, DeviceSpec, LinkSpec, make_device,
                        fit_alpha_beta, fit_lambda, estimate_op_costs,
                        predict_step_times)
from .costmodel import EdgeCost, EdgeCostModel, fit_link_corrections
from .throughput import (IterationEstimate, NodeLoad, estimate_iteration,
                         latency_pipelined, latency_single_pass, node_loads,
                         throughput)
from .partition import (min_bottleneck_chain, partition_equal_compute,
                        partition_equal_number, partition_min_bottleneck)
from .scheduler import (JointPlan, Schedule, SCHEDULERS, louvain_communities,
                        schedule_equal_compute, schedule_equal_number,
                        schedule_joint, schedule_opfence)
from .compression import (CompressionPlan, adaptive_ratios, boundary_compress,
                          compress_for_edge, ef_compress, plan_adatopk,
                          plan_none, plan_uniform, ratio_to_k, topk_decode,
                          topk_mask, topk_select, wire_bytes)
from .rad import (PipelineProgram, init_ef_state, pipeline_loss_and_grad,
                  pipeline_loss_and_grad_ef, pipeline_train_step,
                  single_device_loss_and_grad)
from .executor import (DecentralizedRuntime, KernelTiming, LinkTiming,
                       MigrationSim, SimResult, StepTiming, TelemetrySink,
                       pipeline_fill_seconds, simulate_iteration,
                       simulate_migration)
from . import network
