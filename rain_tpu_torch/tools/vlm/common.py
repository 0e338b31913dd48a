"""Shared helpers of the VLM probes: the port of rain_tpu/tools/vlm/common.py.

Base64 image data URLs and a multi-image chat-completion call. The OpenAI
dependency is imported lazily, so that nothing else needs it. Host only:
the request is text and bytes, with no tensor.
"""

from __future__ import annotations

import base64
import sys
from pathlib import Path


def image_data_url(image_path) -> str:
    data = base64.b64encode(Path(image_path).read_bytes()).decode("utf-8")
    suffix = Path(image_path).suffix.lstrip(".").lower() or "png"
    if suffix == "jpg":
        suffix = "jpeg"
    return f"data:image/{suffix};base64,{data}"


def make_client(api_key: str):
    try:
        from openai import OpenAI
    except ImportError as e:
        sys.exit(f"openai is not installed ({e}); required for VLM tools")
    return OpenAI(api_key=api_key)


def ask_with_images(client, prompt: str, image_paths, *,
                    system: str | None = None, model: str = "gpt-4o",
                    max_tokens: int | None = None) -> str:
    content = []
    if prompt:
        content.append({"type": "text", "text": prompt})
    for p in image_paths:
        content.append({"type": "image_url",
                        "image_url": {"url": image_data_url(p)}})
    messages = []
    if system:
        messages.append({"role": "system", "content": system})
    messages.append({"role": "user", "content": content})
    kwargs = {}
    if max_tokens:
        kwargs["max_tokens"] = max_tokens
    response = client.chat.completions.create(
        model=model, messages=messages, **kwargs)
    return response.choices[0].message.content
