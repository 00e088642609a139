"""Quantization-aware co-exploration (QADAM/QUIDAM direction) on torch.

Searches the joint (accelerator config x per-layer execution precision)
space under k-objective Pareto optimality on top of the mixed-precision
sweep, whose aggregates come from the CUDA sweep kernel on the card.  See
:mod:`repro_torch.explore.space` for the genome encoding,
:mod:`repro_torch.explore.search` for the engines,
:mod:`repro_torch.explore.accuracy` for the accuracy models, and
:func:`repro_torch.core.dse.run` for the one-call entry point.
"""

from repro_torch.explore.accuracy import (AccuracyModel, AccuracySpec,
                                          CalibratedAccuracy, EliteValidation,
                                          ProxyAccuracy, resolve_accuracy,
                                          validate_elites)
from repro_torch.explore.objectives import (DEFAULT_MULTI_OBJECTIVES,
                                            DEFAULT_OBJECTIVES,
                                            LEGACY_OBJECTIVE_ALIASES,
                                            MULTI_OBJECTIVES,
                                            OBJECTIVE_REGISTRY, OBJECTIVES,
                                            ObjectiveSpec,
                                            accuracy_floor_violation,
                                            mode_noise_table, mode_sqnr_db,
                                            multi_objective_matrix,
                                            objective_matrix, quant_noise,
                                            reset_sqnr_table,
                                            resolve_objectives)
from repro_torch.explore.pareto import (crowding_distance, hypervolume,
                                        nondominated_sort, pareto_mask_k,
                                        reference_point)
from repro_torch.explore.search import (SEARCH_METHODS, Evaluator,
                                        SearchResult, nsga2, random_search,
                                        successive_halving)
from repro_torch.explore.space import (CoExploreManySpace, CoExploreSpace,
                                       space_for_workload,
                                       space_for_workloads)

__all__ = [
    "CoExploreSpace", "CoExploreManySpace",
    "space_for_workload", "space_for_workloads",
    "OBJECTIVES", "DEFAULT_OBJECTIVES", "objective_matrix", "quant_noise",
    "MULTI_OBJECTIVES", "DEFAULT_MULTI_OBJECTIVES",
    "multi_objective_matrix", "accuracy_floor_violation", "ObjectiveSpec",
    "OBJECTIVE_REGISTRY", "LEGACY_OBJECTIVE_ALIASES", "resolve_objectives",
    "reset_sqnr_table",
    "mode_noise_table", "mode_sqnr_db",
    "AccuracyModel", "AccuracySpec", "ProxyAccuracy", "CalibratedAccuracy",
    "EliteValidation", "resolve_accuracy", "validate_elites",
    "pareto_mask_k", "nondominated_sort", "crowding_distance",
    "hypervolume", "reference_point",
    "Evaluator", "SearchResult", "SEARCH_METHODS",
    "random_search", "nsga2", "successive_halving",
]
