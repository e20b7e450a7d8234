"""The nuScenes data path of the port (its own copy of the JAX package's
``datasets/``): clip datasets, transforms, BEV maps, box processors, collation into
model batches, bucketed resumable samplers and the threaded loader. Host-side numpy
and PIL; the apps move the batches to the device."""
from .geometry import (boxes_to_corners, ensure_canvas, ensure_positive_z,
                       obtain_next2top, quaternion_to_rotation_matrix,
                       trans_boxes_to_view, trans_boxes_to_views)
from .bbox import pad_bboxes_to_maxlen, preprocess_bbox, preprocess_bbox_keep_all
from .bev import LoadBEVSegmentation, one_hot_decode, one_hot_encode
from .collate import (clip_to_model_batch, collate_clips,
                      collate_fn_single_clip, pad_clip_to_t,
                      pad_model_batch_to_t)
from .dataloader import (DataLoader, concat_batches, make_full_bucket_collate,
                         prepare_dataloader, prepare_multirank_dataloader)
from .nuscenes import (IMG_FPS, max_full_clip_len, NuScenesMultiResDataset,
                       NuScenesTDataset, NuScenesVariableDataset, frame_from_info)
from .sampler import BucketSampler, StatefulSampler
from .transforms import Compose, ImageAug3D, ImageNormalize, ObjectNameFilter
