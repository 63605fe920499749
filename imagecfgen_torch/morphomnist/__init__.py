"""Morpho-MNIST measurement and perturbation, the host-side oracle (port of
``imagecfgen_tpu/morphomnist``, numpy, scipy and the port's own C++ only).

The measurement oracle defines the ground-truth morphometrics (area, stroke
length, thickness, slant, width, height), and the perturbations synthesise
the SCM dataset (SetThickness, SetSlant, SetIntensity, ...). The medial-axis
thinning loop is C++ (``csrc/morphometry.cpp``, ``csrc/skeletonize.cpp``),
built with the host compiler at first use. ``morphomnist/util.py``
(matplotlib plotting) is not ported.
"""
from .io import load_idx, save_idx
from .measure import Morphometrics, measure_batch, measure_image
from .morpho import ImageMoments, ImageMorphology, bounding_parallelogram
