from .film import Film, tone_map
from .imageio import read_exr, save_images, write_exr, write_png
