"""The paper's own workload as a dry-run cell: web-scale sparse logistic
regression (yandex_ad-like: n≫10⁶ examples, p≫10⁶ features), trained with
d-GLMNET on the production mesh.  Rows shard over ``data``, feature blocks
over ``model`` (D=1 recovers the paper's exact 1-D layout).

The dense (n_loc × p_loc) brick is the densified-tile representation from
DESIGN.md §2; the shapes below give a 2 TiB design matrix — 8.6 GiB/chip on
the single-pod mesh."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GLMShape:
    name: str
    n_examples: int
    n_features: int
    tile_size: int
    # brick occupancy of the CSR-of-bricks layout (DESIGN.md §2): 1.0 lowers
    # the dense design path, < 1.0 the blocked-sparse BlockSparseDesign path
    # with brick storage sized to this occupancy.
    occupancy: float = 1.0


GLM_SHAPES = {
    "glm_web": GLMShape("glm_web", n_examples=1 << 19, n_features=1 << 20,
                        tile_size=512),
    "glm_tall": GLMShape("glm_tall", n_examples=1 << 22, n_features=1 << 17,
                         tile_size=512),
    # webspam/clickstream-regime sparsity: 5% of bricks carry nonzeros —
    # per-chip design bytes drop ~20x vs glm_web's dense 8.6 GiB
    "glm_sparse": GLMShape("glm_sparse", n_examples=1 << 19,
                           n_features=1 << 20, tile_size=512,
                           occupancy=0.05),
}
