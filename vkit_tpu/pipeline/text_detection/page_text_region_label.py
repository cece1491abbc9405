"""Text-region label step: char regression labels (centroid + deviate
points with corner-vector geometry), gaussian char heatmap, char masks and
the height score map.

Behavioral spec: vkit/pipeline/text_detection/page_text_region_label.py:
42-648 (re-derived; per-label corner geometry is one vectorized numpy
routine over the 4 corner vectors instead of a Vector-object graph).
"""
import logging
import math
from enum import Enum, unique
from typing import Any, List, Mapping, Optional, Sequence, Tuple

import attr
import numpy as np
from numpy.random import Generator as RandomGenerator
from scipy.spatial import cKDTree

from ...element import Box, Mask, Point, PointList, Polygon, ScoreMap
from ...engine.char_heatmap import (
    CharHeatmapDefaultEngineInitConfig,
    char_heatmap_default_engine_executor_factory,
)
from ...engine.char_mask import (
    CharMaskEngineRunConfig,
    char_mask_engine_executor_aggregator_factory,
)
from ...ops import warp as warp_ops
from ...utility import normalize_to_probs
from ..interface import PipelineStep, PipelineStepFactory
from .page_text_region import PageTextRegionStepOutput

logger = logging.getLogger(__name__)

TWO_PI = 2.0 * math.pi


@attr.define
class PageTextRegionLabelStepConfig:
    char_heatmap_default_engine_init_config: CharHeatmapDefaultEngineInitConfig = (
        attr.field(factory=CharHeatmapDefaultEngineInitConfig)
    )
    char_mask_engine_config: Mapping[str, Any] = attr.field(
        factory=lambda: {'type': 'default'}
    )
    # 1 centroid + n deviate points.
    num_deviate_char_regression_labels: int = 1
    num_deviate_char_regression_labels_candiates_factor: int = 3


@attr.define
class PageTextRegionLabelStepInput:
    page_text_region_step_output: PageTextRegionStepOutput


@unique
class PageCharRegressionLabelTag(Enum):
    CENTROID = 'centroid'
    DEVIATE = 'deviate'


class QuadGeometry:
    """Vectorized corner-vector geometry of one label point inside a quad.

    Computes, in one pass over a (4, 2) xy array of corner offsets:
    per-corner distances, the clockwise corner-angle deltas (whose sum is
    2*pi iff the label point lies inside the quad), and their normalized
    distribution.
    """

    __slots__ = ('distances', 'angles', 'valid', 'up_left_offset')

    def __init__(self, np_corners_xy: np.ndarray, label_x: float, label_y: float):
        offsets = np_corners_xy - np.asarray([label_x, label_y], dtype=np.float64)
        self.distances = np.hypot(offsets[:, 0], offsets[:, 1])
        thetas = np.mod(np.arctan2(offsets[:, 1], offsets[:, 0]), TWO_PI)
        deltas = np.mod(np.roll(thetas, -1) - thetas + math.pi, TWO_PI) - math.pi
        deltas = np.where(deltas < 0, deltas + TWO_PI, deltas)  # clockwise
        self.angles = deltas
        self.valid = math.isclose(float(deltas.sum()), TWO_PI, rel_tol=0.012)
        self.up_left_offset = (float(offsets[0, 1]), float(offsets[0, 0]))  # (y, x)


def _down_edge_orientation_idx(down_left: Point, down_right: Point) -> int:
    """Which side of the bounding box the "down" edge faces:
           0
     +-----------+
     |           |
    2|           |3
     |           |
     +-----------+
           1
    """
    theta = math.atan2(
        down_right.smooth_y - down_left.smooth_y,
        down_right.smooth_x - down_left.smooth_x,
    ) % TWO_PI
    factor = theta / math.pi
    if factor >= 1.75 or factor < 0.25:
        return 1
    if factor < 0.75:
        return 2
    if factor < 1.25:
        return 0
    return 3


@attr.define
class PageCharRegressionLabel:
    char_idx: int
    tag: PageCharRegressionLabelTag
    label_point_smooth_y: float
    label_point_smooth_x: float
    downsampled_label_point_y: int
    downsampled_label_point_x: int
    up_left: Point
    up_right: Point
    down_right: Point
    down_left: Point

    is_downsampled: bool = False
    downsample_labeling_factor: int = 1

    _geometry: Optional[QuadGeometry] = attr.field(default=None, repr=False)

    @property
    def corner_points(self):
        yield from (self.up_left, self.up_right, self.down_right, self.down_left)

    def _np_corners_xy(self) -> np.ndarray:
        return np.asarray(
            [(p.smooth_x, p.smooth_y) for p in self.corner_points],
            dtype=np.float64,
        )

    @property
    def geometry(self) -> QuadGeometry:
        if self._geometry is None:
            self._geometry = QuadGeometry(
                self._np_corners_xy(),
                self.label_point_smooth_x,
                self.label_point_smooth_y,
            )
        return self._geometry

    @property
    def valid(self) -> bool:
        return self.geometry.valid

    # Bounding extents over the corner points.

    @property
    def bounding_smooth_up(self) -> float:
        return min(p.smooth_y for p in self.corner_points)

    @property
    def bounding_smooth_down(self) -> float:
        return max(p.smooth_y for p in self.corner_points)

    @property
    def bounding_smooth_left(self) -> float:
        return min(p.smooth_x for p in self.corner_points)

    @property
    def bounding_smooth_right(self) -> float:
        return max(p.smooth_x for p in self.corner_points)

    @property
    def bounding_center_point(self) -> Point:
        return Point.create(
            y=(self.bounding_smooth_up + self.bounding_smooth_down) / 2,
            x=(self.bounding_smooth_left + self.bounding_smooth_right) / 2,
        )

    @property
    def bounding_smooth_shape(self):
        return (
            self.bounding_smooth_down - self.bounding_smooth_up,
            self.bounding_smooth_right - self.bounding_smooth_left,
        )

    @property
    def bounding_orientation_idx(self) -> int:
        return _down_edge_orientation_idx(self.down_left, self.down_right)

    # Transformations.

    def to_shifted_page_char_regression_label(
        self, offset_y: int, offset_x: int
    ) -> 'PageCharRegressionLabel':
        assert self.valid and not self.is_downsampled
        sy = self.label_point_smooth_y + offset_y
        sx = self.label_point_smooth_x + offset_x
        # A pure shift preserves the corner-vector geometry: reuse it.
        return attr.evolve(
            self,
            label_point_smooth_y=sy,
            label_point_smooth_x=sx,
            downsampled_label_point_y=int(sy),
            downsampled_label_point_x=int(sx),
            up_left=self.up_left.to_shifted_point(offset_y, offset_x),
            up_right=self.up_right.to_shifted_point(offset_y, offset_x),
            down_right=self.down_right.to_shifted_point(offset_y, offset_x),
            down_left=self.down_left.to_shifted_point(offset_y, offset_x),
            geometry=self.geometry,
        )

    def to_downsampled_page_char_regression_label(
        self, downsample_labeling_factor: int
    ) -> 'PageCharRegressionLabel':
        assert self.valid and not self.is_downsampled
        return attr.evolve(
            self,
            is_downsampled=True,
            downsample_labeling_factor=downsample_labeling_factor,
            downsampled_label_point_y=int(
                self.label_point_smooth_y // downsample_labeling_factor
            ),
            downsampled_label_point_x=int(
                self.label_point_smooth_x // downsample_labeling_factor
            ),
            geometry=self.geometry,
        )

    # Model-facing encodings.

    def generate_up_left_offsets(self):
        return self.geometry.up_left_offset

    def generate_clockwise_angle_distribution(self):
        return normalize_to_probs(list(self.geometry.angles))

    def generate_clockwise_distances(self):
        return tuple(float(d) for d in self.geometry.distances)


@attr.define
class PageTextRegionLabelStepOutput:
    page_char_mask: Mask
    page_char_height_score_map: ScoreMap
    page_char_gaussian_score_map: ScoreMap
    page_char_regression_labels: Sequence[PageCharRegressionLabel]
    page_char_bounding_box_mask: Mask


def _label_for(char_idx: int, tag: PageCharRegressionLabelTag, point: Point,
               quad: Sequence[Point]) -> PageCharRegressionLabel:
    return PageCharRegressionLabel(
        char_idx=char_idx,
        tag=tag,
        label_point_smooth_y=point.smooth_y,
        label_point_smooth_x=point.smooth_x,
        downsampled_label_point_y=point.y,
        downsampled_label_point_x=point.x,
        up_left=quad[0],
        up_right=quad[1],
        down_right=quad[2],
        down_left=quad[3],
    )


class PageTextRegionLabelStep(
    PipelineStep[PageTextRegionLabelStepConfig, PageTextRegionLabelStepInput, PageTextRegionLabelStepOutput]
):

    def __init__(self, config: PageTextRegionLabelStepConfig):
        super().__init__(config)
        self.char_heatmap_engine = char_heatmap_default_engine_executor_factory.create(
            config.char_heatmap_default_engine_init_config
        )
        self.char_mask_engine = (
            char_mask_engine_executor_aggregator_factory.create_engine_executor(
                config.char_mask_engine_config
            )
        )

    def _char_masks(self, shape, inactive_mask: Mask, char_polygons,
                    region_polygons, region_indices):
        height, width = shape
        result = self.char_mask_engine.run(CharMaskEngineRunConfig(
            height=height,
            width=width,
            char_polygons=char_polygons,
            char_bounding_polygons=[region_polygons[i] for i in region_indices],
        ))
        inactive_mask.fill_mask(result.combined_chars_mask, 0)
        return result.combined_chars_mask, result.char_masks

    @classmethod
    def _height_score_map(cls, shape, inactive_mask: Mask, char_polygons,
                          per_char_masks) -> ScoreMap:
        heights = np.asarray([p.get_rectangular_height() for p in char_polygons])
        score_map = ScoreMap.from_shape(shape, is_prob=False)
        # Tall chars paint first so overlapped small chars keep their label.
        for idx in np.argsort(heights)[::-1]:
            idx = int(idx)
            source = char_polygons[idx] if per_char_masks is None \
                else per_char_masks[idx]
            source.fill_score_map(score_map, value=float(heights[idx]))
        inactive_mask.fill_score_map(score_map, 0.0)
        return score_map

    def _sample_deviate_points(self, polygon: Polygon, count: int,
                               page_shape, rng: RandomGenerator) -> PointList:
        """Random interior points of the bounding box, mapped through the
        box->quad homography onto the page."""
        bb = polygon.bounding_box
        raw = np.stack([
            rng.integers(1, bb.width - 1, count).astype(np.float64),
            rng.integers(1, bb.height - 1, count).astype(np.float64),
        ], axis=1)

        np_box_quad = np.asarray(
            [(0, 0), (bb.width - 1, 0),
             (bb.width - 1, bb.height - 1), (0, bb.height - 1)],
            dtype=np.float64,
        )
        to_quad = warp_ops.solve_perspective(
            np_box_quad, polygon.internals.np_self_relative_points.astype(np.float64)
        )
        mapped = warp_ops.affine_np_points(to_quad.astype(np.float32), raw)

        page_height, page_width = page_shape
        xs = np.clip(mapped[:, 0] + bb.left, 0, page_width - 1)
        ys = np.clip(mapped[:, 1] + bb.up, 0, page_height - 1)
        return PointList(
            Point.create(y=float(y), x=float(x)) for x, y in zip(xs, ys)
        )

    def _regression_labels(self, shape, char_polygons,
                           rng: RandomGenerator) -> List[PageCharRegressionLabel]:
        cfg = self.config
        centers = PointList(p.get_center_point() for p in char_polygons)
        kd_tree = cKDTree(centers.to_np_array())

        labels: List[PageCharRegressionLabel] = []
        for char_idx, (polygon, center) in enumerate(zip(char_polygons, centers)):
            assert polygon.num_points == 4
            quad = polygon.points

            centroid = _label_for(
                char_idx, PageCharRegressionLabelTag.CENTROID, center, quad
            )
            assert centroid.valid
            labels.append(centroid)

            if cfg.num_deviate_char_regression_labels <= 0:
                continue
            bb = polygon.bounding_box
            if bb.height <= 2 or bb.width <= 2:
                continue

            candidates = self._sample_deviate_points(
                polygon,
                cfg.num_deviate_char_regression_labels_candiates_factor
                * cfg.num_deviate_char_regression_labels,
                shape, rng,
            )
            # A deviate point must still be closest to its own char.
            _, np_nearest = kd_tree.query(candidates.to_np_array(), k=[1])
            own = (np_nearest[:, 0] == char_idx).tolist()

            kept = 0
            for point, is_own in zip(candidates, own):
                if kept >= cfg.num_deviate_char_regression_labels:
                    break
                if not is_own:
                    continue
                deviate = _label_for(
                    char_idx, PageCharRegressionLabelTag.DEVIATE, point, quad
                )
                if deviate.valid:
                    labels.append(deviate)
                    kept += 1
            if kept < cfg.num_deviate_char_regression_labels:
                logger.warning(f'not enough deviate labels for char {char_idx}')

        return labels

    @staticmethod
    def _bounding_box_mask(shape, labels) -> Mask:
        height, width = shape
        mask = Mask.from_shape(shape)
        for label in labels:
            box = Box(
                max(0, math.floor(label.bounding_smooth_up)),
                min(height - 1, math.ceil(label.bounding_smooth_down)),
                max(0, math.floor(label.bounding_smooth_left)),
                min(width - 1, math.ceil(label.bounding_smooth_right)),
            )
            if box.valid:
                box.fill_mask(mask)
        return mask

    def run(self, input: PageTextRegionLabelStepInput, rng: RandomGenerator):
        src = input.page_text_region_step_output
        shape = src.page_image.shape
        inactive = src.page_active_mask.to_inverted_mask()

        char_mask, per_char_masks = self._char_masks(
            shape, inactive, src.page_char_polygons,
            src.page_text_region_polygons,
            src.page_char_polygon_text_region_polygon_indices,
        )
        height_score_map = self._height_score_map(
            shape, inactive, src.page_char_polygons, per_char_masks
        )
        gaussian = self.char_heatmap_engine.run({
            'height': shape[0],
            'width': shape[1],
            'char_polygons': src.page_char_polygons,
        }).score_map
        labels = self._regression_labels(shape, src.page_char_polygons, rng)

        return PageTextRegionLabelStepOutput(
            page_char_mask=char_mask,
            page_char_height_score_map=height_score_map,
            page_char_gaussian_score_map=gaussian,
            page_char_regression_labels=labels,
            page_char_bounding_box_mask=self._bounding_box_mask(shape, labels),
        )


page_text_region_label_step_factory = PipelineStepFactory(PageTextRegionLabelStep)
