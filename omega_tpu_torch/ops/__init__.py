from omega_tpu_torch.ops.trisk import (
    div_cell,
    grad_edge,
    curl_vertex,
    tangential_edge,
    interp_cell_to_edge_aniso,
    interp_cell_to_edge_iso,
)
