"""The SMPL pedestrian pipeline of the port: pose smoothing (``pose``), texture
harvest and re-render (``processor``), the SMPL body and HMR2 fitter (``smpl``)."""
from .pose import PoseProcessor
from .processor import (BodyModel, PedestrianProcessor, SegformerSegmenter,
                        SyntheticBody, SyntheticSegmenter, SyntheticSmplFitter,
                        make_synthetic_processor)
from .smpl import (Hmr2SmplFitter, SmplBody, load_smpl_pickle,
                   make_real_processor)
