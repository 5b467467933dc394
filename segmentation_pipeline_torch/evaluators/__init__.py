from .contour_image_evaluator import ContourImageEvaluator
from .evaluator import Evaluator
from .image_region_evaluator import ImageRegionEvaluator
from .instance_segmentation_evaluator import (InstanceSegmentationEvaluator,
                                              connected_components, msseg_detection_test,
                                              overlap_histogram)
from .label_map_evaluator import LabelMapEvaluator
from .labeled_tensor import LabeledTensor, Table
from .segmentation_evaluator import SegmentationEvaluator

__all__ = ["ContourImageEvaluator", "Evaluator", "ImageRegionEvaluator",
           "InstanceSegmentationEvaluator", "connected_components", "msseg_detection_test",
           "overlap_histogram", "LabelMapEvaluator", "LabeledTensor", "Table",
           "SegmentationEvaluator"]
