from .sizes import ImageSizes, get_image_sizes  # noqa: F401
from .serialization import load_pth, save_pth  # noqa: F401
from . import image_io  # noqa: F401
