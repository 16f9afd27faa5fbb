"""OpenCV's polygon extraction, in numpy: the labelme polygons of the quality
protocol's eval ground truth (`mask_to_polygons`), without OpenCV.

  - `find_contours`: `cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)`,
    Suzuki-Abe border following on the mask padded with one zero pixel, as OpenCV's
    scanner does it: the raster scan starts an outer border where a 0 is followed by an
    unmarked 1, unless the last marked border pixel met on the row is marked positive
    (the start is then inside another border); the follower marks each border pixel
    -126 where its right neighbour is a 0 it examined, else 2; the chain keeps a point
    where the direction changes; contours come out in reverse order of their starts;
  - `contour_area`: `cv2.contourArea`, the shoelace formula;
  - `arc_length`: `cv2.arcLength(closed=True)`, float32 segment lengths summed in
    float64 in order;
  - `approx_poly_dp`: `cv2.approxPolyDP(closed=True)`, Ramer-Douglas-Peucker from
    OpenCV's start (the farther end of three farthest-point passes from point 0), its
    stack order, a point's distance taken to the chord's segment (not its line: a
    point beyond an end is as far as that end), and its last pass that drops points on
    near-straight runs. Integer arithmetic, exact, where OpenCV's doubles are exact too.

Points are int32 [K, 2] arrays of (x, y), as OpenCV's [K, 1, 2] without the middle axis.
"""

from __future__ import annotations

import numpy as np

# chain code s -> (dx, dy): right, then counter-clockwise on the screen (y grows down)
CODE_DELTAS = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))
MARK = 2            # a followed border pixel
RIGHT_MARK = -126   # one whose right neighbour is a 0 the follower examined (2 | -128)


def _follow(flat: np.ndarray, i0: int, width: int, x: int, y: int) -> np.ndarray:
    """Follow the outer border that starts at flat index i0 = pixel (x, y) of the
    padded image, marking its pixels; the chain's corner points in padded coordinates."""
    step = [1, -width + 1, -width, -width - 1, -1, width - 1, width, width + 1] * 2
    s = s_end = 4
    while True:     # the last nonzero neighbour, clockwise from the left one
        s = (s - 1) & 7
        i1 = i0 + step[s]
        if flat[i1] != 0 or s == s_end:
            break
    if s == s_end:  # a single pixel
        flat[i0] = RIGHT_MARK
        return np.array([[x, y]], np.int32)
    pts = []
    i3, prev_s = i0, s ^ 4
    while True:
        s_end = s
        while s < 15:
            s += 1
            i4 = i3 + step[s]
            if flat[i4] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:
            flat[i3] = RIGHT_MARK
        elif flat[i3] == 1:
            flat[i3] = MARK
        if s != prev_s:
            pts.append((x, y))
            prev_s = s
        x += CODE_DELTAS[s][0]
        y += CODE_DELTAS[s][1]
        if i4 == i0 and i3 == i1:
            break
        i3 = i4
        s = (s + 4) & 7
    return np.array(pts, np.int32)


def find_contours(mask: np.ndarray) -> list[np.ndarray]:
    """The outer borders of a 2-D mask (nonzero is foreground) as
    `cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]`."""
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"mask must be 2-D, got shape {mask.shape}")
    h, w = mask.shape
    img = np.zeros((h + 2, w + 2), np.int8)
    img[1:-1, 1:-1] = mask != 0
    width = w + 2
    flat = img.reshape(-1)
    found = []
    for y in range(1, h + 1):
        row = img[y]
        lnbd = 0        # the last marked border pixel met on this row (0: none)
        x = 1
        while x < width:
            changes = np.flatnonzero(row[x:] != row[x - 1:-1]) + x
            resume = width
            for cx in changes.tolist():
                prev, p = int(row[cx - 1]), int(row[cx])
                if prev == 0 and p == 1:
                    if row[lnbd] > 0:       # inside another outer border
                        continue
                    found.append(_follow(flat, y * width + cx, width, cx, y) - 1)
                    resume = cx + 1         # the row's marks changed: scan it again
                    break
                if p == 0 and prev >= 1:    # a hole border, not followed
                    if prev != 1:
                        lnbd = cx - 1
                elif p not in (0, 1):
                    lnbd = cx
            x = resume
    return found[::-1]


def contour_area(points: np.ndarray) -> float:
    """`cv2.contourArea(points)`: the unsigned shoelace area."""
    p = np.asarray(points, np.int64).reshape(-1, 2)
    if len(p) < 3:
        return 0.0
    q = np.roll(p, 1, axis=0)
    return abs(float((q[:, 0] * p[:, 1] - q[:, 1] * p[:, 0]).sum()) * 0.5)


def arc_length(points: np.ndarray) -> float:
    """`cv2.arcLength(points, closed=True)`: float32 segment lengths, summed in float64
    in order from the closing segment."""
    p = np.asarray(points, np.float32).reshape(-1, 2)
    if len(p) <= 1:
        return 0.0
    d = p - np.roll(p, 1, axis=0)
    seg = np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    return float(np.cumsum(seg.astype(np.float64))[-1])


def approx_poly_dp(points: np.ndarray, epsilon: float) -> np.ndarray:
    """`cv2.approxPolyDP(points, epsilon, closed=True)[:, 0, :]` of an integer curve."""
    src = [tuple(int(v) for v in q) for q in np.asarray(points).reshape(-1, 2)]
    count = len(src)
    if count == 0:
        return np.zeros((0, 2), np.int32)
    eps = epsilon * epsilon
    dst, stack = [], []

    # 1. approximately the two farthest points: three passes, each from the farthest
    # point of the last
    pos = right_start = 0
    le_eps = False
    for _ in range(3):
        max_dist = 0
        pos = (pos + right_start) % count
        start = src[pos]
        pos = (pos + 1) % count
        for j in range(1, count):
            pt = src[pos]
            pos = (pos + 1) % count
            dist = (pt[0] - start[0]) ** 2 + (pt[1] - start[1]) ** 2
            if dist > max_dist:
                max_dist, right_start = dist, j
        le_eps = max_dist <= eps
    if le_eps:
        dst.append(start)
    else:
        first = pos % count
        far = (right_start + first) % count
        stack += [(far, first), (first, far)]

    # 2. split each slice at its farthest point from the chord until within epsilon
    while stack:
        s_start, s_end = stack.pop()
        end = src[s_end]
        start = src[s_start]
        pos = (s_start + 1) % count
        if pos != s_end:
            dx, dy = end[0] - start[0], end[1] - start[1]
            if dx == 0 and dy == 0:
                raise ValueError("approx_poly_dp: a slice starts and ends at one point")
            chord = dx * dx + dy * dy
            max_dist = 0    # the squared distance to the chord's segment, times chord
            while pos != s_end:
                pt = src[pos]
                pos = (pos + 1) % count
                ux, uy = pt[0] - start[0], pt[1] - start[1]
                along = ux * dx + uy * dy
                if along < 0:
                    dist = (ux * ux + uy * uy) * chord
                elif along > chord:
                    dist = ((pt[0] - end[0]) ** 2 + (pt[1] - end[1]) ** 2) * chord
                else:
                    dist = (uy * dx - ux * dy) ** 2
                if dist > max_dist:
                    max_dist, right_start = dist, (pos + count - 1) % count
            le_eps = float(max_dist) <= eps * float(chord)
        else:
            le_eps = True
        if le_eps:
            dst.append(start)
        else:
            stack += [(right_start, s_end), (s_start, right_start)]

    # 3. drop points on near-straight runs
    count = new_count = len(dst)
    pos = count - 1
    start = dst[pos]
    pos = wpos = (pos + 1) % count
    pt = dst[pos]
    pos = (pos + 1) % count
    i = 0
    while i < count and new_count > 2:
        end = dst[pos]
        pos = (pos + 1) % count
        dx, dy = end[0] - start[0], end[1] - start[1]
        dist = abs((pt[0] - start[0]) * dy - (pt[1] - start[1]) * dx)
        inner = (pt[0] - start[0]) * (end[0] - pt[0]) + (pt[1] - start[1]) * (end[1] - pt[1])
        if (float(dist * dist) <= 0.5 * eps * float(dx * dx + dy * dy) and dx != 0
                and dy != 0 and inner >= 0):
            new_count -= 1
            dst[wpos] = start = end
            wpos = (wpos + 1) % count
            pt = dst[pos]
            pos = (pos + 1) % count
            i += 2
            continue
        dst[wpos] = start = pt
        wpos = (wpos + 1) % count
        pt = end
        i += 1
    return np.array(dst[:new_count], np.int32).reshape(-1, 2)


def mask_to_polygons(mask: np.ndarray) -> list[list[list[int]]]:
    """The labelme `segmentation` polygons of a binary mask: its three largest outer
    borders of area >= 16, each simplified to 0.4% of its perimeter, kept when at least
    3 points remain (`scripts/quality_run.py mask_to_polygons`, without OpenCV)."""
    polys = []
    for c in sorted(find_contours(mask), key=contour_area, reverse=True)[:3]:
        if contour_area(c) < 16:
            continue
        pts = approx_poly_dp(c, 0.004 * arc_length(c))
        if len(pts) >= 3:
            polys.append(pts.astype(int).tolist())
    return polys
