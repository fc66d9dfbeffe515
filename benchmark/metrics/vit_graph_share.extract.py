"""vit_graph_share.extract (%): the share of stage 1's ViT forwards that a
CUDA graph's replay served: 100 x the port's counter `vit.graph_replays`
over the `vit.extract` spans (`extract_patch_keys` calls) opened in the
traced window. 0 where every forward ran eagerly; None where the window
opened no `vit.extract` span, or the port replays no graph (it has no
`models.vit.graphs_forward`, the rule that decides which forwards do).
Moves `images_per_s`."""
from benchmark import spans


def _port_graphs() -> bool:
    try:
        from deep_spectral_tpu_torch.models import vit
    except ImportError:
        return False
    return hasattr(vit, "graphs_forward")


def read(run):
    calls = spans.opened("vit.extract")
    if not calls or not _port_graphs():
        return None
    return 100.0 * spans.total("vit.graph_replays") / calls
