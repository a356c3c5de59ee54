"""Single-image detection demo on the card (the port of detect_demo.py).

    python examples/torch_detect_demo.py --image imgs/dog-cycle-car.png \
        --weights yolov3.weights --names data/coco.names
"""

import argparse

import cv2

from yolo_v3_tpu_torch.detector import Detector
from yolo_v3_tpu_torch.viz.draw import save_detections_image


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", required=True)
    ap.add_argument("--weights", required=True)
    ap.add_argument("--names", required=True)
    ap.add_argument("--out", default="detections.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    classes = [ln.strip() for ln in open(args.names) if ln.strip()]
    det = Detector.from_darknet_weights(args.weights, device=args.device)

    img = cv2.cvtColor(cv2.imread(args.image), cv2.COLOR_BGR2RGB)
    rows = det.detect([img])[0]  # [cls, x, y, w, h, prob, obj]
    for r in rows:
        print(f"{classes[int(r[0])]:20s} prob={r[5]:.3f} "
              f"box=({r[1]:.0f}, {r[2]:.0f}, {r[3]:.0f}, {r[4]:.0f})")
    save_detections_image(img, rows, args.out, classes)
    print("saved", args.out)


if __name__ == "__main__":
    main()
