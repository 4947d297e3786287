from repro_torch.core import adversary, compression  # noqa: F401
from repro_torch.core.adversary import (  # noqa: F401
    ATTACK_IDS,
    ATTACK_STREAM,
    ATTACKS,
    Adversary,
    apply_attack,
    attack_ids,
    make_attack_sampler,
)
from repro_torch.core.compression import (  # noqa: F401
    COMPRESS_METHODS,
    ef_transmit,
    init_ef,
    validate_method,
)
from repro_torch.core.interop import (  # noqa: F401
    from_reference,
    make_replay_sampler,
    sparse_from_reference,
)
from repro_torch.core.kgt_minimax import (  # noqa: F401
    KGTState,
    correction_mean_norm,
    diagnostics,
    init_state,
    make_round_step,
    mean_over_clients,
    point_etas,
)
from repro_torch.core.minimax import MinimaxProblem  # noqa: F401
from repro_torch.core.mixing import (  # noqa: F401
    MIXING_IMPLS,
    ROBUST_IMPLS,
    ROBUST_RULES,
    consensus_error,
    make_mixer,
    make_traced_mixer,
    mix_dense,
    mix_packed,
    mix_ring,
    mix_sparse,
    robust_mix_dense,
    robust_mix_packed,
    robust_mix_sparse,
    robust_rule,
)
from repro_torch.core.objectives import (  # noqa: F401
    adversarial_problem,
    dro_problem,
    make_quadratic_data,
    quadratic_cell_problem,
    quadratic_problem,
)
from repro_torch.core.packing import PackSpec, pack, pack_spec, unpack  # noqa: F401
from repro_torch.core.topology import mixing_matrix, spectral_gap  # noqa: F401
from repro_torch.core.sparse_topology import (  # noqa: F401
    SPARSE_TOPOLOGIES,
    SparseTopology,
    densify,
    from_dense,
    make_sparse_w_sampler,
    sparse_masked_w,
    sparse_mixing_matrix,
)
from repro_torch.core.stochastic_topology import (  # noqa: F401
    TOPOLOGY_FAMILIES,
    make_participation_sampler,
    make_w_sampler,
    masked_w,
)
